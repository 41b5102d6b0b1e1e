"""The port's CUDA sources on the CPU through the host emulation
(``copenerf_torch/ops/kernels/emulate.py``): every kernel, launched by its
own wrapper on CPU tensors, held against its plain version at the small
widths of the other port tests (SDF scale 1.3, so a fault in the scale's
place shows; the default config's scale is 1), with both ray vectors (the
folded render core K6, like K1, with the positive one only), on a ragged row
count (150 rows: two full tiles of 64 and a tail).

Tolerances, as ``chip_smoke.py``: forward outputs 1e-4 absolute (grad 1e-4
of its largest entry, at least 1e-4); every gradient tensor of a backward
kernel within 2x the plain f32 version's relative error against f64, or
1e-5. Skips where there is no ``g++``. This shows indexing, layout and
argument faults and wrong arithmetic; only the card shows that ``nvcc``
builds the sources and what they cost (``test_torch_gpu.py``)."""

import shutil

import pytest

from copenerf_torch.ops.kernels import emulate

FORWARD = ["K2", "K4-fwd out", "K4-fwd grad", "K5-fwd", "K7-fwd"]
BACKWARD = ["K3-bwd", "K4-bwd obar", "K4-bwd gbar", "K4-bwd both", "K5-bwd",
            "K7-bwd"]
CHECKS = {
    "positive": FORWARD + ["K1-fwd sdf", "K1-fwd grad", "K1-fwd color"]
                + [f"K6-fwd {o}" for o in ("sdf", "grad", "color", "sdf_w")]
                + BACKWARD + ["K1-bwd", "K1-bwd frozen", "K6-bwd"],
    "negative": FORWARD + BACKWARD + ["K4 + K5 composed"],
}


@pytest.fixture(scope="module")
def results():
    if shutil.which("g++") is None:
        pytest.skip("the host emulation of the CUDA kernels needs g++")
    with emulate.emulated():
        return {ray: emulate.check("small", ray == "negative", n=150)
                for ray in CHECKS}


@pytest.mark.parametrize("ray,name", [(ray, name) for ray, names in CHECKS.items()
                                      for name in names])
def test_emulated_kernel_matches_plain(results, ray, name):
    ok, err, limit = results[ray][name]
    assert ok, f"{ray} ray vector, {name}: {err} > {limit}"


def test_emulation_checks_every_kernel(results):
    for ray, names in CHECKS.items():
        assert sorted(results[ray]) == sorted(names), ray
