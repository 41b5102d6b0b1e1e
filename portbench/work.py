"""Operations and bytes from shapes, from a configuration's sizes alone.

Every count is of the products that the mathematics of a call needs, each
once: a forward that an implementation recomputes in its backward is not
counted again. A multiply-add is two operations. Bytes are each input read
once and each output written once, the weights read once and their
gradients written once. Elementwise work (activations, positional
encoding, compositing) is not counted as operations.

Peaks are NVIDIA's published dense rates of one H100 SXM at 700 W: TF32 on
the tensor cores (no f32-accurate product can run faster, so a share of it
cannot pass 100%) and HBM3 bandwidth.
"""

from __future__ import annotations

import dataclasses

TF32_PEAK = 495e12      # FLOP/s, dense TF32 tensor cores
HBM_RATE = 3.35e12      # bytes/s


def pe_dim(d: int, multires: int) -> int:
    return d * (1 + 2 * multires) if multires > 0 else d


def mlp_layers(d0: int, hidden: int, n_layers: int, d_out: int, skips):
    """(in, out) of every linear layer of an IDR MLP of ``n_layers`` hidden
    layers: the layer that feeds a skip outputs ``hidden - d0``, so that the
    concatenation with the input restores the width."""
    dims = [d0] + [hidden] * n_layers + [d_out]
    out = []
    for l in range(len(dims) - 1):
        width = dims[l + 1] - d0 if (l + 1) in skips else dims[l + 1]
        out.append((dims[l], width))
    return out


@dataclasses.dataclass(frozen=True)
class Shapes:
    """Multiply-adds per row of each part of the field networks."""
    sdf_hidden: int      # every SDF hidden layer (H)
    sdf_first: int       # the first hidden layer, on the encoded input
    hidden: int          # the SDF hidden width
    sdf_out: int         # the SDF head's width (value + feature)
    sdf_pe_in: int       # the encoded input's width x the raw input's
    color: int           # every color layer (C)
    motion: int          # every motion layer

    @staticmethod
    def of(cfg: dict) -> "Shapes":
        s = cfg["neus_sdf_network"]
        c = cfg["neus_rendering_network"]
        m = cfg["motion_network"]
        d0 = pe_dim(s["d_in"], s["multires"])
        sdf = mlp_layers(d0, s["d_hidden"], s["n_layers"], s["d_out"],
                         s["skip_in"])
        c0 = c["d_in"] + c["d_feature"] + pe_dim(3, c["multires_view"]) - 3
        color = mlp_layers(c0, c["d_hidden"], c["n_layers"], c["d_out"], ())
        m0 = pe_dim(m["d_in"], m["multires"])
        motion = mlp_layers(m0, m["d_hidden"], m["n_layers"], m["d_out"],
                            m["skip_in"])
        return Shapes(
            sdf_hidden=sum(a * b for a, b in sdf[:-1]),
            sdf_first=sdf[0][0] * sdf[0][1], hidden=s["d_hidden"],
            sdf_out=s["d_out"], sdf_pe_in=d0 * s["d_in"],
            color=sum(a * b for a, b in color),
            motion=sum(a * b for a, b in motion))

    @property
    def feature(self) -> int:
        """The head's feature columns (F)."""
        return self.hidden * (self.sdf_out - 1)


def weight_bytes(cfg: dict, nets=("sdf", "color")) -> int:
    """f32 bytes of the nets' effective weights and biases."""
    s = cfg["neus_sdf_network"]
    c = cfg["neus_rendering_network"]
    total = 0
    if "sdf" in nets:
        d0 = pe_dim(s["d_in"], s["multires"])
        total += sum(a * b + b for a, b in mlp_layers(
            d0, s["d_hidden"], s["n_layers"], s["d_out"], s["skip_in"]))
    if "color" in nets:
        c0 = c["d_in"] + c["d_feature"] + pe_dim(3, c["multires_view"]) - 3
        total += sum(a * b + b for a, b in mlp_layers(
            c0, c["d_hidden"], c["n_layers"], c["d_out"], ()))
    return 4 * total


def k2_work(cfg: dict, n: int):
    """(FLOP, bytes) of the SDF value on n rows (K2, K3-fwd): the hidden
    layers and the head's column 0; x in (16 B), the value out (4 B)."""
    sh = Shapes.of(cfg)
    macs = sh.sdf_hidden + sh.hidden
    return 2 * macs * n, 20 * n + weight_bytes(cfg, ("sdf",))


def k3_bwd_work(cfg: dict, n: int):
    """(FLOP, bytes) of the SDF value's first-order backward on n rows: the
    data sweep to x and the weight gradients, each the forward's size; x
    and the cotangent in (20 B), x_bar out (16 B)."""
    sh = Shapes.of(cfg)
    macs = 2 * (sh.sdf_hidden + sh.hidden)
    return 2 * macs * n, 36 * n + 2 * weight_bytes(cfg, ("sdf",))


def k1_fwd_work(cfg: dict, n: int):
    """(FLOP, bytes) of the render-core forward on n rows: the SDF forward
    with the full head, the gradient's reverse sweep (head column 0, every
    hidden layer, the encoding's Jacobian), the color MLP; x and dirs in
    (28 B), sdf, grad and color out (32 B)."""
    sh = Shapes.of(cfg)
    fwd = sh.sdf_hidden + sh.hidden * sh.sdf_out
    sweep = sh.hidden + sh.sdf_hidden + sh.sdf_pe_in
    macs = fwd + sweep + sh.color
    return 2 * macs * n, 60 * n + weight_bytes(cfg)


def k1_bwd_work(cfg: dict, n: int, weight_grads: bool = True):
    """(FLOP, bytes) of the render core's second-order backward on n rows,
    no forward recomputed: the tangent sweep of the gradient's cotangent up
    every hidden layer (H), the backprop down every hidden layer to x (H),
    the head's and the color MLP's data products (F + hidden, C); with
    ``weight_grads`` one outer product per hidden layer and channel (2H),
    the head (hidden x out, and its column 0 for the tangent channel) and
    the color layers (C). x, dirs, sbar, gbar, cbar in (60 B); x_bar,
    dirs_bar out (28 B); the weights read, their gradients written."""
    sh = Shapes.of(cfg)
    data = 2 * sh.sdf_hidden + sh.feature + sh.hidden + sh.color
    macs = data
    nbytes = 88 * n + weight_bytes(cfg)
    if weight_grads:
        macs += (2 * sh.sdf_hidden + sh.hidden * sh.sdf_out + sh.hidden
                 + sh.color)
        nbytes += weight_bytes(cfg)
    return 2 * macs * n, nbytes


def motion_flop(cfg: dict, queries: int, backward: bool) -> int:
    """FLOP of the motion MLP on ``queries`` times: its forward, and with
    ``backward`` the data and weight products."""
    return 2 * Shapes.of(cfg).motion * queries * (3 if backward else 1)


def sweep_points(cfg: dict) -> int:
    """Points per ray that the importance sweeps query (K2): the uniform
    samples, then every up-sampling round but the last."""
    r = cfg["neus_renderer"]
    per = r["n_importance"] // r["up_sample_steps"]
    return r["n_samples"] + per * (r["up_sample_steps"] - 1)


def samples(cfg: dict) -> int:
    r = cfg["neus_renderer"]
    return r["n_samples"] + r["n_importance"]


def train_step_flop(cfg: dict, rays: int, stage1: bool,
                    train_motion: bool, n_frames: int) -> int:
    """Model FLOP of one train step: the sweeps, the render core forward and
    backward with weight gradients; in stage 1 the sdf-consistency value
    and its backward (K3) and the motion chain (every frame's substeps and
    the scene-flow query)."""
    n = rays * samples(cfg)
    flop = (k2_work(cfg, rays * sweep_points(cfg))[0] + k1_fwd_work(cfg, n)[0]
            + k1_bwd_work(cfg, n)[0])
    if stage1:
        flop += k2_work(cfg, n)[0] + k3_bwd_work(cfg, n)[0]
        queries = (n_frames - 1) * cfg["training"]["nb_sample_timestep"] + 1
        flop += motion_flop(cfg, queries, backward=train_motion)
    return flop


def render_flop(cfg: dict, rays: int) -> int:
    """Model FLOP of rendering ``rays`` rays: the sweeps and K1-fwd."""
    return (k2_work(cfg, rays * sweep_points(cfg))[0]
            + k1_fwd_work(cfg, rays * samples(cfg))[0])


def pose_step_flop(cfg: dict, rays: int) -> int:
    """Model FLOP of one test-time pose step: the sweeps, K1-fwd and K1-bwd
    without weight gradients (the fields are frozen)."""
    n = rays * samples(cfg)
    return (k2_work(cfg, rays * sweep_points(cfg))[0] + k1_fwd_work(cfg, n)[0]
            + k1_bwd_work(cfg, n, weight_grads=False)[0])


def roofline_s(flop: float, nbytes: float) -> float:
    """The least time the card could take: operations at the TF32 peak or
    bytes at HBM rate, whichever is longer."""
    return max(flop / TF32_PEAK, nbytes / HBM_RATE)
