"""Port parity for the image metrics and LPIPS: the port's
``evaluation/metrics_image.py``, ``lpips_torch.py`` and ``lpips_export.py``
against the JAX package's on the CPU (the JAX side at HIGHEST precision).

Inputs are made by numpy from a seed: a smooth scene-like image and its
render-like degradations (noise, blur, a 2-pixel shift), and a pair of
uniform random images. LPIPS runs on random VGG16 and head weights in the
shapes of the torchvision checkpoints (conv weights N(0, 0.05^2), heads
|N(0, 1)|), written as ``.npz`` and as torch ``.pth`` state dicts.

Tolerances, f32 on both sides (measured gaps in brackets):
  * SSIM: 1e-6 absolute [4.2e-7; the f64 evaluation 1.8e-7 from the f32];
  * PSNR: 1e-6 relative [9.8e-8, one f32 spacing]. An absolute 1e-6 is
    below f32's spacing at the values measured (1.9e-6 between 16 and 32
    dB), so the bound is the same 1e-6 taken relative;
  * LPIPS: 1e-5 relative [7.6e-7];
  * the LPIPS pack: the same arrays, exactly, from either package's export.
"""

import os
import sys
import types
import warnings

import jax
import numpy as np
import pytest
import torch

from copenerf_tpu.evaluation import lpips_export as j_export
from copenerf_tpu.evaluation import lpips_jax
from copenerf_tpu.evaluation import metrics_image as j_metrics
from copenerf_torch.evaluation import evaluator as TE
from copenerf_torch.evaluation import lpips_export as t_export
from copenerf_torch.evaluation import lpips_torch
from copenerf_torch.evaluation import metrics_image as t_metrics

H, W = 60, 80
SSIM_ATOL = 1e-6
PSNR_RTOL = 1e-6
LPIPS_RTOL = 1e-5

_VGG_CONV_SHAPES = [
    (0, 64, 3), (2, 64, 64),
    (5, 128, 64), (7, 128, 128),
    (10, 256, 128), (12, 256, 256), (14, 256, 256),
    (17, 512, 256), (19, 512, 512), (21, 512, 512),
    (24, 512, 512), (26, 512, 512), (28, 512, 512),
]


def fake_state(seed=0):
    """Random torchvision-vgg16 features and v0.1 heads, numpy."""
    rng = np.random.RandomState(seed)
    vgg = {}
    for i, c_out, c_in in _VGG_CONV_SHAPES:
        vgg[f"features.{i}.weight"] = rng.randn(
            c_out, c_in, 3, 3).astype(np.float32) * 0.05
        vgg[f"features.{i}.bias"] = rng.randn(c_out).astype(np.float32) * 0.05
    lin = {f"lin{s}.model.1.weight": np.abs(
        rng.randn(1, ch, 1, 1).astype(np.float32))
        for s, ch in enumerate(lpips_torch.STAGE_CHANNELS)}
    return vgg, lin


def write_state(folder, vgg, lin, fmt):
    os.makedirs(folder, exist_ok=True)
    if fmt == "npz":
        paths = (os.path.join(folder, "vgg16.npz"),
                 os.path.join(folder, "vgg.npz"))
        np.savez(paths[0], **vgg)
        np.savez(paths[1], **lin)
    else:
        paths = (os.path.join(folder, "vgg16.pth"),
                 os.path.join(folder, "vgg.pth"))
        for path, sd in zip(paths, (vgg, lin)):
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return paths


def scene_image(rng):
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    img = np.stack([0.5 + 0.3 * np.sin(0.15 * xs + 0.1 * (c + 1) * ys + c)
                    for c in range(3)])
    img += 0.1 * rng.uniform(-1, 1, size=img.shape)
    return np.clip(img, 0, 1).astype(np.float32)


def blur(img):
    pad = np.pad(img, ((0, 0), (1, 1), (1, 1)), mode="edge")
    return sum(pad[:, dy:dy + H, dx:dx + W] for dy in range(3)
               for dx in range(3)) / 9.0


PAIRS = ["noise", "blur", "shift", "random"]


def pair(kind, seed=0):
    rng = np.random.default_rng(seed)
    a = scene_image(rng)
    if kind == "noise":
        b = a + rng.normal(scale=0.05, size=a.shape)
    elif kind == "blur":
        b = blur(a)
    elif kind == "shift":
        b = np.roll(a, 2, axis=2)
    else:
        a = rng.uniform(size=a.shape)
        b = rng.uniform(size=a.shape)
    return a.astype(np.float32), np.clip(b, 0, 1).astype(np.float32)


@pytest.mark.parametrize("kind", PAIRS)
def test_psnr_ssim_match_jax(kind):
    a, b = pair(kind)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    got_p = float(t_metrics.psnr(ta, tb))
    got_s = float(t_metrics.ssim(ta, tb))
    ref_p = float(j_metrics.psnr(a, b))
    ref_s = float(j_metrics.ssim(a, b))
    np.testing.assert_allclose(got_p, ref_p, rtol=PSNR_RTOL, atol=0)
    np.testing.assert_allclose(got_s, ref_s, rtol=0, atol=SSIM_ATOL)
    assert -1 <= got_s <= 1
    np.testing.assert_array_equal(t_metrics.gaussian_window(),
                                  j_metrics._gaussian_window())


def test_ssim_identity_and_f64():
    """SSIM of an image with itself is 1; the f64 evaluation of the same
    function agrees with the f32 one to 1e-6."""
    a, b = pair("noise")
    ta = torch.from_numpy(a)
    assert float(t_metrics.ssim(ta, ta)) == pytest.approx(1.0, abs=1e-6)
    got = float(t_metrics.ssim(ta, torch.from_numpy(b)))
    ref = float(t_metrics.ssim(ta.double(), torch.from_numpy(b).double()))
    assert abs(got - ref) <= SSIM_ATOL


@pytest.fixture(scope="module")
def lpips_pair(tmp_path_factory):
    """A degraded pair and the JAX package's LPIPS of it."""
    a, b = pair("noise", seed=3)
    params = lpips_jax.load_weights(*write_state(
        str(tmp_path_factory.mktemp("lpips_ref")), *fake_state(), "npz"))
    return a, b, float(jax.jit(lpips_jax.lpips)(params, a, b))


@pytest.mark.parametrize("fmt", ["npz", "pth"])
def test_lpips_matches_jax(tmp_path, lpips_pair, fmt):
    a, b, ref = lpips_pair
    params = lpips_torch.load_weights(
        *write_state(str(tmp_path), *fake_state(), fmt))
    assert [len(s) for s in params["stages"]] == [2, 2, 3, 3, 3]
    got = float(lpips_torch.lpips(params, torch.from_numpy(a),
                                  torch.from_numpy(b)))
    np.testing.assert_allclose(got, ref, rtol=LPIPS_RTOL, atol=0)
    assert got > 0
    assert float(lpips_torch.lpips(params, a, a)) == 0.0


def test_lpips_fn_from_env(tmp_path, monkeypatch, lpips_pair):
    """The pack named by the env vars: ``lpips_fn`` returns a callable that
    gives the JAX package's value, without a warning."""
    a, b, ref = lpips_pair
    vgg, lin = write_state(str(tmp_path), *fake_state(), "npz")
    monkeypatch.setenv("COPENERF_LPIPS_VGG", vgg)
    monkeypatch.setenv("COPENERF_LPIPS_LIN", lin)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fn = t_metrics.lpips_fn(device="cpu")
    assert fn is not None
    np.testing.assert_allclose(fn(a, b), ref, rtol=LPIPS_RTOL, atol=0)


def test_missing_weights_warn_and_report_nan(tmp_path, monkeypatch):
    """No pack: ``lpips_fn`` warns and returns None, and ``image_eval``
    reports LPIPS as NaN beside finite PSNR and SSIM. A pack that does
    not load warns too."""
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("COPENERF_LPIPS_VGG", raising=False)
    monkeypatch.delenv("COPENERF_LPIPS_LIN", raising=False)
    assert lpips_torch.default_weight_paths() == (None, None)
    with pytest.warns(UserWarning, match="LPIPS unavailable: no VGG16"):
        assert t_metrics.lpips_fn(device="cpu") is None
    logged = []
    fake = types.SimpleNamespace(device=torch.device("cpu"),
                                 _log=logged.append)
    a, b = pair("blur")
    gt = [np.transpose(a, (1, 2, 0))]
    preds = [{"color": np.transpose(b, (1, 2, 0))}]
    with pytest.warns(UserWarning, match="LPIPS unavailable"):
        out = TE.Evaluator.image_eval(fake, gt, preds)
    assert np.isnan(out["LPIPS"])
    assert np.isfinite(out["PSNR"]) and -1 <= out["SSIM"] <= 1
    assert any("LPIPS unavailable" in m for m in logged)
    bad = tmp_path / "broken.npz"
    np.savez(bad, x=np.zeros(1))
    monkeypatch.setenv("COPENERF_LPIPS_VGG", str(bad))
    monkeypatch.setenv("COPENERF_LPIPS_LIN", str(bad))
    with pytest.warns(UserWarning, match="failed to load the weights"):
        assert t_metrics.lpips_fn(device="cpu") is None


def test_export_packs_match_and_cross_load(tmp_path):
    """Both packages' ``lpips_export`` on the same sources (a torchvision
    ``.pth`` and pip-lpips-style heads) write the same arrays; each
    package's ``load_weights`` reads the other's pack to the same
    weights."""
    vgg, lin = fake_state(seed=1)
    src_vgg = str(tmp_path / "vgg16-397923af.pth")
    src_lin = str(tmp_path / "heads.pth")
    torch.save({k: torch.from_numpy(v) for k, v in vgg.items()}, src_vgg)
    torch.save({f"lins.{k[3]}.model.1.weight": torch.from_numpy(v)
                for k, v in lin.items()}, src_lin)
    t_paths = t_export.export(vgg=src_vgg, lin=src_lin,
                              out_dir=str(tmp_path / "port"))
    j_paths = j_export.export(vgg=src_vgg, lin=src_lin,
                              out_dir=str(tmp_path / "jax"))
    for tp, jp in zip(t_paths, j_paths):
        assert os.path.basename(tp) == os.path.basename(jp)
        with np.load(tp) as t, np.load(jp) as j:
            assert sorted(t.files) == sorted(j.files)
            for k in t.files:
                np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    port_reads_jax = lpips_torch.load_weights(*j_paths)
    jax_reads_port = lpips_jax.load_weights(*t_paths)
    for ts, js in zip(port_reads_jax["stages"], jax_reads_port["stages"]):
        for tl, jl in zip(ts, js):
            np.testing.assert_array_equal(tl["w"].numpy(), np.asarray(jl["w"]))
            np.testing.assert_array_equal(tl["b"].numpy(), np.asarray(jl["b"]))
    for th, jh in zip(port_reads_jax["heads"], jax_reads_port["heads"]):
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


def test_export_cli_self_check_and_no_network(tmp_path, capsys, monkeypatch):
    """The port's CLI writes the pack and runs its self-check; asking for
    the torchvision download where it cannot happen (torchvision made
    unimportable: other tests of the suite install a stub of it) fails
    with one clear line and exit code 2."""
    vgg, lin = fake_state(seed=2)
    src_vgg = str(tmp_path / "vgg16.npz")
    src_lin = str(tmp_path / "lin.npz")
    np.savez(src_vgg, **vgg)
    np.savez(src_lin, **lin)
    out = str(tmp_path / "pack")
    t_export.main(["--vgg", src_vgg, "--lin", src_lin, "--out", out])
    text = capsys.readouterr().out
    assert "self-check lpips(rand, rand)" in text
    assert sorted(os.listdir(out)) == ["vgg.npz", "vgg16.npz"]
    monkeypatch.setitem(sys.modules, "torchvision", None)
    monkeypatch.setitem(sys.modules, "torchvision.models", None)
    with pytest.raises(SystemExit) as exc:
        t_export.main(["--from-torchvision", "--lin", src_lin, "--out", out])
    assert exc.value.code == 2
    assert "lpips_export:" in capsys.readouterr().err
