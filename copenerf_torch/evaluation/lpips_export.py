"""Export protocol LPIPS weights into the npz pack both packages read (port
of ``copenerf_tpu/evaluation/lpips_export.py``; the pack is the one
``lpips_torch`` and the JAX package's ``lpips_jax`` load).

The reference fetches the v0.1 VGG linear heads at runtime
(``lpipsPyTorch/modules/utils.py:11-30``) and pulls the
VGG16 backbone from torchvision (``modules/networks.py:88-96``). This
zero-egress build instead ingests user-provided weights; this module is the
one documented command that converts ANY of the common checkpoint layouts
into the canonical pack (``vgg16.npz`` + ``vgg.npz``) in the default search
directory, with shape validation and a self-check:

    python -m copenerf_torch.evaluation.lpips_export \
        --vgg  ~/Downloads/vgg16-397923af.pth \
        --lin  ~/Downloads/vgg.pth

Accepted sources:
  * ``--vgg``: a torchvision ``vgg16`` state dict (full-model
    ``features.N.*`` or bare ``N.*`` keys), ``.pth`` or ``.npz``;
  * ``--lin``: the PerceptualSimilarity v0.1 VGG linear heads in any of the
    circulating key layouts (``lin{k}.model.1.weight``, the post-rename
    ``{k}.1.weight``, or the pip-lpips ``lins.{k}.model.1.weight``);
  * ``--combined``: one full ``lpips.LPIPS(net='vgg')`` state dict (pip
    ``lpips`` package: ``net.slice{s}.{N}.weight`` + ``lin{k}...``), which
    contains both;
  * ``--from-torchvision``: pull the VGG16 backbone via torchvision's
    pretrained download (needs egress; fails with a clear message here).

Output pack format (what ``lpips_torch.load_weights`` reads):
  * ``vgg16.npz``: ``features.{i}.weight`` (OIHW f32) / ``features.{i}.bias``
    for i in the 13 VGG16 conv indices 0..28;
  * ``vgg.npz``: ``lin{k}.model.1.weight`` (1, C_k, 1, 1) f32, k = 0..4.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .lpips_torch import (STAGE_CHANNELS, _VGG16_STAGES, _as_numpy_state,
                          load_weights)

# Conv input-channel progression of VGG16 features (index -> (out, in)).
_CONV_SHAPES = {}
_in_ch = 3
for _stage, _out_ch in zip(_VGG16_STAGES, STAGE_CHANNELS):
    for _i in _stage:
        _CONV_SHAPES[_i] = (_out_ch, _in_ch)
        _in_ch = _out_ch

DEFAULT_OUT = os.path.expanduser("~/.cache/copenerf_tpu/lpips")


def _extract_vgg(state: dict) -> dict:
    """Normalize any accepted VGG16 layout to ``features.{i}.weight/bias``
    with shape validation."""
    out = {}
    for i, (c_out, c_in) in _CONV_SHAPES.items():
        for leaf in ("weight", "bias"):
            val = None
            for key in (f"features.{i}.{leaf}", f"{i}.{leaf}"):
                if key in state:
                    val = np.asarray(state[key], np.float32)
                    break
            if val is None:
                # pip-lpips combined layout: net.slice{s}.{i}.{leaf} —
                # slice number is irrelevant, the torchvision index i is
                # preserved inside each slice.
                for s in range(1, 6):
                    key = f"net.slice{s}.{i}.{leaf}"
                    if key in state:
                        val = np.asarray(state[key], np.float32)
                        break
            if val is None:
                raise KeyError(f"VGG16 checkpoint missing conv {i} {leaf}")
            want = (c_out, c_in, 3, 3) if leaf == "weight" else (c_out,)
            if val.shape != want:
                raise ValueError(
                    f"features.{i}.{leaf}: shape {val.shape} != {want} — "
                    "not a VGG16 'features' checkpoint")
            out[f"features.{i}.{leaf}"] = val
    return out


def _extract_lin(state: dict) -> dict:
    """Normalize any accepted linear-head layout to
    ``lin{k}.model.1.weight`` with shape validation."""
    out = {}
    for k, ch in enumerate(STAGE_CHANNELS):
        val = None
        for key in (f"lin{k}.model.1.weight",       # PerceptualSimilarity
                    f"lins.{k}.model.1.weight",     # pip lpips (ModuleList)
                    f"{k}.1.weight",                # post-get_state_dict
                    f"lin.{k}.model.1.weight"):
            if key in state:
                val = np.asarray(state[key], np.float32)
                break
        if val is None:
            raise KeyError(f"linear-head checkpoint missing lin{k} "
                           f"(tried lin{k}.model.1.weight and variants)")
        want = (1, ch, 1, 1)
        if val.shape != want:
            raise ValueError(f"lin{k}: shape {val.shape} != {want}")
        out[f"lin{k}.model.1.weight"] = val
    return out


def export(vgg: str | None = None, lin: str | None = None,
           combined: str | None = None, out_dir: str = DEFAULT_OUT,
           from_torchvision: bool = False) -> tuple[str, str]:
    """Convert checkpoints to the canonical pack; returns the two npz
    paths. Raises KeyError/ValueError on unrecognized or malformed input."""
    if combined is not None:
        state = _as_numpy_state(combined)
        vgg_sd = _extract_vgg(state)
        lin_sd = _extract_lin(state)
    else:
        if from_torchvision:
            import torchvision.models as tvm

            model = tvm.vgg16(weights=tvm.VGG16_Weights.IMAGENET1K_V1)
            vgg_sd = _extract_vgg(
                {k: v.detach().numpy()
                 for k, v in model.features.state_dict().items()})
        elif vgg is not None:
            vgg_sd = _extract_vgg(_as_numpy_state(vgg))
        else:
            raise ValueError("need --vgg, --combined, or --from-torchvision "
                             "for the VGG16 backbone")
        if lin is None:
            raise ValueError("need --lin (or --combined) for the v0.1 "
                             "linear heads")
        lin_sd = _extract_lin(_as_numpy_state(lin))

    os.makedirs(out_dir, exist_ok=True)
    vgg_path = os.path.join(out_dir, "vgg16.npz")
    lin_path = os.path.join(out_dir, "vgg.npz")
    np.savez(vgg_path, **vgg_sd)
    np.savez(lin_path, **lin_sd)
    return vgg_path, lin_path


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Export LPIPS weights to the npz pack of copenerf_torch "
        "and copenerf_tpu")
    ap.add_argument("--vgg", help="torchvision vgg16 state dict (.pth/.npz)")
    ap.add_argument("--lin", help="PerceptualSimilarity v0.1 vgg.pth heads")
    ap.add_argument("--combined",
                    help="one full lpips.LPIPS(net='vgg') state dict")
    ap.add_argument("--from-torchvision", action="store_true",
                    help="download the VGG16 backbone via torchvision "
                    "(requires network access)")
    ap.add_argument("--out", default=DEFAULT_OUT,
                    help=f"output directory (default: {DEFAULT_OUT}, the "
                    "evaluator's search path)")
    args = ap.parse_args(argv)

    try:
        vgg_path, lin_path = export(
            vgg=args.vgg, lin=args.lin, combined=args.combined,
            out_dir=args.out, from_torchvision=args.from_torchvision)
    except Exception as exc:  # CLI surface: one clear line, nonzero exit
        ap.exit(2, f"lpips_export: {exc}\n")

    # Self-check: the pack must round-trip through the evaluator's loader
    # and produce a finite, positive distance on a fixed pair.
    params = load_weights(vgg_path, lin_path)
    from .lpips_torch import lpips

    rng = np.random.RandomState(0)
    a = rng.rand(3, 32, 32).astype(np.float32)
    b = rng.rand(3, 32, 32).astype(np.float32)
    val = float(lpips(params, a, b))
    assert np.isfinite(val) and val > 0, val
    print(f"wrote {vgg_path}\nwrote {lin_path}\n"
          f"self-check lpips(rand, rand) = {val:.6f} (finite, > 0)")
    if args.out == DEFAULT_OUT:
        print("the evaluators of both packages now report protocol LPIPS.")
    else:
        print("point COPENERF_LPIPS_VGG / COPENERF_LPIPS_LIN at the files "
              "above (non-default directory).")


if __name__ == "__main__":
    main()
