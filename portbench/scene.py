"""The inputs of a run, made on the device from the seed: the networks'
weights, the video's frames, the cameras, the train / test split and the
per-view tables, and seeded poses. Both the program and the reference are
handed these; neither makes its own.

Every draw comes from one ``torch.Generator`` on the run's device in a few
large calls, so the same seed gives the same inputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .work import mlp_layers, pe_dim

NETS = ("sdf", "color", "motion")


def layer_dims(cfg: dict) -> dict:
    s = cfg["neus_sdf_network"]
    c = cfg["neus_rendering_network"]
    m = cfg["motion_network"]
    c0 = c["d_in"] + c["d_feature"] + pe_dim(3, c["multires_view"]) - 3
    return {
        "sdf": mlp_layers(pe_dim(s["d_in"], s["multires"]), s["d_hidden"],
                          s["n_layers"], s["d_out"], s["skip_in"]),
        "color": mlp_layers(c0, c["d_hidden"], c["n_layers"], c["d_out"], ()),
        "motion": mlp_layers(pe_dim(m["d_in"], m["multires"]), m["d_hidden"],
                             m["n_layers"], m["d_out"], m["skip_in"]),
    }


def make_weights(cfg: dict, gen: torch.Generator, device) -> dict:
    """``{net: [(v, g, b)]}`` and ``variance``. The SDF is a sphere of
    radius 2 around the origin, positive inside (the camera sits inside and
    sees the wall, as an inside-out NeuS init does): the hidden layers
    Kaiming-normal, the head at NeuS's geometric init with its sign turned,
    each bias and the head perturbed by N(0, 0.1 / sqrt(fan_in)); the color
    and motion nets draw at PyTorch's default scale. ``g`` is each row's
    norm, so W = v at the start."""
    out = {}
    for net, dims in layer_dims(cfg).items():
        sizes = [a * b for a, b in dims]
        z = torch.randn(sum(sizes) + sum(b for _, b in dims), generator=gen,
                        device=device)
        zw, zb = torch.split(z, [sum(sizes), sum(b for _, b in dims)])
        layers = []
        for l, ((d_in, d_out), zv, bz) in enumerate(zip(
                dims, torch.split(zw, sizes), torch.split(zb, [b for _, b in dims]))):
            zv = zv.reshape(d_out, d_in)
            noise = 0.1 / math.sqrt(d_in)
            if net != "sdf":
                v = zv / math.sqrt(3 * d_in)
                b = bz / math.sqrt(3 * d_in)
            elif l == len(dims) - 1:
                v = -math.sqrt(math.pi) / math.sqrt(d_in) + noise * zv
                b = 2.0 + noise * bz
            else:
                v = math.sqrt(2.0 / d_out) * zv
                b = noise * bz
                # The encoding's columns (layer 0's after the raw input, the
                # skip layer's last ones), zero in a geometric init, get
                # small weights: |grad sdf| stays near 1, as in a trained
                # field, and no column is zero.
                s = cfg["neus_sdf_network"]
                n_pe = dims[0][0] - s["d_in"]
                cols = (slice(s["d_in"], None) if l == 0 else
                        slice(d_in - n_pe, None) if l in s["skip_in"] else None)
                if cols is not None:
                    v[:, cols] = 0.01 / math.sqrt(d_in) * zv[:, cols]
            layers.append((v.contiguous(), torch.linalg.norm(v, dim=1),
                           b.contiguous()))
        out[net] = layers
    out["variance"] = torch.tensor(
        float(cfg["neus_variance_network"]["init_val"]), device=device)
    return out


def load_program_weights(fields, weights: dict) -> None:
    """Copy the weights into the program's networks (``v``, ``g``, ``b`` of
    each ``lin<l>``) and its variance."""
    with torch.no_grad():
        for net in NETS:
            for l, (v, g, b) in enumerate(weights[net]):
                layer = fields[net].layers[f"lin{l}"]
                layer.v.copy_(v)
                layer.g.copy_(g)
                layer.b.copy_(b)
        fields["variance"].variance.copy_(weights["variance"])


def leaves(weights: dict) -> dict:
    """The trainable leaves by name, ``<net>.lin<l>.<v|g|b>`` and
    ``variance.variance``, as the program names its parameters."""
    out = {}
    for net in NETS:
        for l, layer in enumerate(weights[net]):
            for name, t in zip("vgb", layer):
                out[f"{net}.lin{l}.{name}"] = t
    out["variance.variance"] = weights["variance"]
    return out


def make_frames(gen, n: int, h: int, w: int, device) -> torch.Tensor:
    """(n, 3, h, w) uint8 frames: uniform noise on a grid of 16-pixel cells,
    bilinearly upsampled (smooth, as photographs are at that scale)."""
    frames = torch.empty((n, 3, h, w), dtype=torch.uint8, device=device)
    coarse = torch.rand((n, 3, h // 16 + 2, w // 16 + 2), generator=gen,
                        device=device)
    for i in range(0, n, 8):
        up = F.interpolate(coarse[i:i + 8], size=(h, w), mode="bilinear",
                           align_corners=False)
        frames[i:i + 8] = (up * 255.0 + 0.5).to(torch.uint8)
    return frames


def camera_mat(cfg: dict) -> np.ndarray:
    """The NDC-style camera matrix of the configuration's frames."""
    h, w = cfg["training"]["resolution"]
    f = float(cfg["assumed"]["focal_px"])
    return np.array([[2 * f / w, 0, 0, 0], [0, -2 * f / h, 0, 0],
                     [0, 0, -1, 0], [0, 0, 0, 1]], np.float32)


def split(cfg: dict):
    """(i_train, i_test) of the video: every ``sample_rate``-th frame from
    ``sample_rate // 2`` is a test frame."""
    n = int(cfg["assumed"]["n_frames"])
    sr = int(cfg["dataloading"]["sample_rate"])
    i_test = list(range(n))[sr // 2::sr]
    i_train = [i for i in range(n) if i not in i_test]
    return i_train, i_test


def ref_tables(cfg: dict):
    """Per train view: reference frame ids (target + interval, clamped),
    in-list masks (the reference is not a test frame) and valid-flow masks
    (it also exists)."""
    n = int(cfg["assumed"]["n_frames"])
    i_train, i_test = split(cfg)
    intervals = cfg["dataloading"]["random_ref_interval"]
    idxs = np.zeros((len(i_train), len(intervals)), np.int64)
    in_list = np.zeros(idxs.shape, np.float32)
    valid = np.zeros(idxs.shape, np.float32)
    for pos, target in enumerate(i_train):
        for t, interval in enumerate(intervals):
            ref = target + interval
            idxs[pos, t] = min(ref, n - 1)
            if ref in i_test:
                continue
            in_list[pos, t] = 1.0
            valid[pos, t] = float(ref < n)
    return idxs, in_list, valid


def world_cam(cfg: dict) -> int:
    """The world camera: the middle frame, or the train frame before it."""
    i_train, _ = split(cfg)
    wci = int(cfg["assumed"]["n_frames"]) // 2
    while wci not in i_train:
        wci -= 1
    return wci


def frame_time(i: int, n: int) -> float:
    return i / (n - 1) * 2.0 - 1.0


def near_identity_poses(gen, n: int, rot: float, trans: float, device):
    """(n, 4, 4) rigid transforms: rotations of uniform axis-angle up to
    ``rot`` in each component, translations up to ``trans``."""
    u = torch.rand((n, 6), generator=gen, device=device) * 2 - 1
    r, t = u[:, :3] * rot, u[:, 3:] * trans
    angle = torch.linalg.norm(r, dim=1, keepdim=True).clamp_min(1e-12)
    k = r / angle
    kx = torch.zeros((n, 3, 3), device=device)
    kx[:, 0, 1], kx[:, 0, 2] = -k[:, 2], k[:, 1]
    kx[:, 1, 0], kx[:, 1, 2] = k[:, 2], -k[:, 0]
    kx[:, 2, 0], kx[:, 2, 1] = -k[:, 1], k[:, 0]
    a = angle[..., None]
    rmat = (torch.eye(3, device=device) + torch.sin(a) * kx
            + (1 - torch.cos(a)) * kx @ kx)
    out = torch.eye(4, device=device).repeat(n, 1, 1)
    out[:, :3, :3] = rmat
    out[:, :3, 3] = t
    return out
