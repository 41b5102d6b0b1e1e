"""LPIPS (VGG16 backbone, v0.1 linear heads) in PyTorch (port of
``copenerf_tpu/evaluation/lpips_jax.py``).

The reference's metric (``lpipsPyTorch/modules/lpips.py:8-36``,
``modules/networks.py:12-96``): VGG16 features at relu1_2, relu2_2, relu3_3,
relu4_3 and relu5_3 of the input shifted and scaled by the LPIPS constants,
channel-unit-normalized feature differences squared, 1x1 linear heads, the
spatial mean, summed over the 5 stages.

No pretrained weights ship with the repo and nothing is downloaded: the
weights come from files the user provides, the same pack the JAX package
reads (``lpips_export`` writes it):

  * the VGG16 file: a torchvision ``vgg16`` state dict (``.pth`` / ``.pt``)
    or an ``.npz`` with the same ``features.N.weight`` / ``.bias`` keys;
  * the head file: the LPIPS v0.1 linear heads (``lin0.model.1.weight`` ...
    ``lin4.model.1.weight``) as a state dict or an ``.npz``.

Search order: ``$COPENERF_LPIPS_VGG`` / ``$COPENERF_LPIPS_LIN``, then
``~/.cache/copenerf_tpu/lpips/`` (one folder for both packages).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from .metrics_image import exact_f32

# torchvision vgg16 ``features`` conv indices, grouped by LPIPS stage.
_VGG16_STAGES = (
    (0, 2),              # -> relu1_2,  64 ch
    (5, 7),              # -> relu2_2, 128 ch
    (10, 12, 14),        # -> relu3_3, 256 ch
    (17, 19, 21),        # -> relu4_3, 512 ch
    (24, 26, 28),        # -> relu5_3, 512 ch
)
STAGE_CHANNELS = (64, 128, 256, 512, 512)

# LPIPS input scaling layer constants (lpipsPyTorch/modules/networks.py).
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def _as_numpy_state(path: str) -> dict:
    """A torch state dict or an npz as {key: np.ndarray}."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def load_weights(vgg_path: str, lin_path: str, device="cpu") -> dict:
    """``{"stages": [[{"w", "b"}, ...] x 5], "heads": [w x 5]}`` of f32
    tensors on ``device`` from a torchvision-vgg16 and a linear-head
    checkpoint; conv weights in torch's OIHW layout."""
    vgg = _as_numpy_state(vgg_path)

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def vkey(i, leaf):
        for k in (f"features.{i}.{leaf}", f"{i}.{leaf}"):
            if k in vgg:
                return vgg[k]
        raise KeyError(f"vgg16 checkpoint missing features.{i}.{leaf}")

    stages = [[{"w": tensor(vkey(i, "weight")), "b": tensor(vkey(i, "bias"))}
               for i in idxs] for idxs in _VGG16_STAGES]

    lin = _as_numpy_state(lin_path)
    heads = []
    for s in range(5):
        for k in (f"lin{s}.model.1.weight", f"lin.{s}.model.1.weight"):
            if k in lin:
                heads.append(tensor(lin[k]))
                break
        else:
            raise KeyError(f"linear-head checkpoint missing lin{s}")
    return {"stages": stages, "heads": heads}


def _vgg_features(params: dict, x: torch.Tensor) -> list:
    """x (1, 3, H, W), already scaled -> the 5 stage activations."""
    feats = []
    for si, stage in enumerate(params["stages"]):
        for layer in stage:
            x = F.relu(F.conv2d(x, layer["w"], layer["b"], padding=1))
        feats.append(x)
        if si < 4:
            x = F.max_pool2d(x, 2, 2)
    return feats


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(f ** 2, dim=1, keepdim=True))
    return f / (norm + eps)


def lpips(params: dict, img1, img2) -> torch.Tensor:
    """(3, H, W) images in [0, 1] -> scalar LPIPS distance, computed in the
    weights' dtype and device (f32 as ``load_weights`` gives them) with
    exact f32 convolutions.

    Protocol quirk, kept: the reference feeds [0, 1] images straight into
    its LPIPS with NO [-1, 1] rescale (``eval.py:201-206`` ->
    ``lpipsPyTorch/modules/lpips.py:30`` z-scores the raw input).
    """
    w0 = params["heads"][0]
    shift = torch.as_tensor(_SHIFT, dtype=w0.dtype,
                            device=w0.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, dtype=w0.dtype,
                            device=w0.device)[None, :, None, None]

    def prep(im):
        im = torch.as_tensor(im).to(device=w0.device, dtype=w0.dtype)
        return (im[None] - shift) / scale

    with exact_f32():
        f1 = _vgg_features(params, prep(img1))
        f2 = _vgg_features(params, prep(img2))
        total = torch.zeros((), dtype=w0.dtype, device=w0.device)
        for a, b, head in zip(f1, f2, params["heads"]):
            diff = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            total = total + torch.mean(F.conv2d(diff, head), dim=(2, 3))[0, 0]
    return total


def default_weight_paths():
    """(vgg, lin) paths: the env vars, then the shared cache folder; None
    where nothing is found."""
    vgg = os.environ.get("COPENERF_LPIPS_VGG")
    lin = os.environ.get("COPENERF_LPIPS_LIN")
    cache = os.path.expanduser("~/.cache/copenerf_tpu/lpips")
    if vgg is None:
        for name in ("vgg16.pth", "vgg16.npz"):
            p = os.path.join(cache, name)
            if os.path.isfile(p):
                vgg = p
                break
    if lin is None:
        for name in ("vgg.pth", "lin_vgg.pth", "vgg.npz"):
            p = os.path.join(cache, name)
            if os.path.isfile(p):
                lin = p
                break
    return vgg, lin


def lpips_fn_torch(device="cuda"):
    """A ``(img1, img2) -> float`` callable on ``device``, or None if no
    weights are found."""
    vgg, lin = default_weight_paths()
    if vgg is None or lin is None:
        return None
    params = load_weights(vgg, lin, device=device)

    @torch.no_grad()
    def compute(img1, img2):
        return float(lpips(params, img1, img2))

    return compute
