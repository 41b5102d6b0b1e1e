"""Host-side weight packing and geometry checks for the CUDA field kernels.

The kernels take every weight as one flat f32 buffer plus named float
offsets into it (the ``off_*`` arguments of the C entry points, which fill
``csrc/mlp_tile.cuh``'s ``Offsets``). This module alone decides the layout.
Weight norm is materialized here (``effective_weight``), as the JAX package
does outside its kernels (``sdf_kernels.py`` ``_prep``):

  * ``w[l]``, ``b[l]``: SDF hidden layer l, W_l (in, out) and b_l;
    ``wt[l]``: W_l^T (out, in) for the gradient sweep;
  * ``w_last0``, ``b_last0``: the last SDF layer's column 0 (hidden,) and
    its bias; ``w_feat``, ``b_feat``: its feature columns (hidden, d_feat)
    and their bias;
  * ``wc[l]``, ``bc[l]``: color layer l (in, out); layer 0 has its input
    rows permuted to [feature, x, PE(dirs), grad] and zero-padded to k0 (a
    multiple of 4).

A pack is cached on the SDF network, keyed by the storage and version of
every parameter it reads, so a render call packs once and an in-place
update (an optimizer step) or a move to another device repacks.
"""

from __future__ import annotations

import torch

from ...models.embedder import embed_dim

MAX_SDF_HIDDEN_LAYERS = 16   # mlp_tile.cuh kMaxSdfHidden
MAX_COLOR_LAYERS = 6         # mlp_tile.cuh kMaxColorLayers
MAX_WIDTH = 256              # shared-memory row buffers


def sdf_skip(cfg) -> int:
    return cfg.skip_in[0] if cfg.skip_in else -1


def check_sdf_geometry(cfg) -> None:
    """Raise for an SDF config the kernels do not take."""
    n_lin = len(cfg.dims) - 1
    d0 = cfg.dims[0]
    problems = []
    if cfg.d_in != 4:
        problems.append("d_in must be 4")
    if cfg.multires <= 0:
        problems.append("multires must be > 0")
    if cfg.d_hidden > MAX_WIDTH or cfg.d_hidden % 4:
        problems.append(f"d_hidden must be a multiple of 4 <= {MAX_WIDTH}")
    if d0 > MAX_WIDTH:
        problems.append(f"PE width {d0} > {MAX_WIDTH}")
    if n_lin - 1 > MAX_SDF_HIDDEN_LAYERS:
        problems.append(f"more than {MAX_SDF_HIDDEN_LAYERS} hidden layers")
    if len(cfg.skip_in) > 1:
        problems.append("at most one skip layer")
    if cfg.skip_in:
        s = cfg.skip_in[0]
        if not 1 <= s <= n_lin - 2:
            problems.append("skip layer must be in [1, n_lin - 2]")
        if cfg.d_hidden - d0 <= 0 or (cfg.d_hidden - d0) % 4:
            problems.append("d_hidden - PE width must be a positive multiple of 4")
    if problems:
        raise ValueError("SDF config not supported by the CUDA kernels: "
                         + "; ".join(problems))


def color_k0(ccfg) -> int:
    """Padded color input width: d_feat + d_pts + d_view + d_grad -> x4."""
    k = ccfg.dims[0]
    return k + (-k) % 4


def check_color_geometry(sdf_cfg, ccfg) -> None:
    problems = []
    if ccfg.mode != "idr" or ccfg.use_negative_ray_vector:
        problems.append("only mode idr with a positive ray vector")
    if ccfg.d_in != 11 or ccfg.d_out != 3:
        problems.append("d_in must be 11 and d_out 3")
    if (ccfg.d_feature != sdf_cfg.d_out - 1 or ccfg.d_feature > MAX_WIDTH
            or ccfg.d_feature % 4):
        problems.append("d_feature must be sdf d_out - 1, a multiple of 4 "
                        "<= 256")
    if ccfg.d_hidden > MAX_WIDTH or ccfg.d_hidden % 4:
        problems.append(f"d_hidden must be a multiple of 4 <= {MAX_WIDTH}")
    if len(ccfg.dims) - 1 > MAX_COLOR_LAYERS:
        problems.append(f"more than {MAX_COLOR_LAYERS} layers")
    if problems:
        raise ValueError("color config not supported by the CUDA kernel: "
                         + "; ".join(problems))


class _Packer:
    def __init__(self):
        self.parts = []
        self.offs = {}
        self.size = 0

    def add(self, name: str, t: torch.Tensor) -> None:
        """Append ``t`` as ``offs[name]``, or as the next entry of the list
        ``offs[name]`` for a per-layer name."""
        flat = t.detach().reshape(-1).float()
        pad = (-flat.numel()) % 4          # keep every piece 16-byte aligned
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        if name in _PER_LAYER:
            self.offs.setdefault(name, []).append(self.size)
        else:
            self.offs[name] = self.size
        self.parts.append(flat)
        self.size += flat.numel()

    def done(self):
        return torch.cat(self.parts).contiguous(), self.offs


_PER_LAYER = ("w", "b", "wt", "wc", "bc")


def _add_sdf(pk: _Packer, sdf_net, with_feature: bool) -> None:
    n_lin = len(sdf_net.cfg.dims) - 1
    for l in range(n_lin - 1):
        layer = sdf_net.layers[f"lin{l}"]
        w = layer.effective_weight()                   # (out, in)
        pk.add("w", w.t().contiguous())
        pk.add("b", layer.b)
        if with_feature:
            pk.add("wt", w)
    last = sdf_net.layers[f"lin{n_lin - 1}"]
    w = last.effective_weight()                        # (d_out, hidden)
    pk.add("w_last0", w[0])
    pk.add("b_last0", last.b[:1])
    if with_feature:
        pk.add("w_feat", w[1:].t().contiguous())
        pk.add("b_feat", last.b[1:])


def _cached(sdf_net, name: str, nets, make):
    """``make()``, reused while no parameter of ``nets`` was replaced or
    modified in place since the last call."""
    key = tuple((p.data_ptr(), p._version) for net in nets
                for p in net.parameters())
    hit = sdf_net.__dict__.get(name)
    if hit is not None and hit[0] == key:
        return hit[1]
    with torch.no_grad():
        packed = make()
    sdf_net.__dict__[name] = (key, packed)
    return packed


def _pack_sdf_value(sdf_net):
    pk = _Packer()
    _add_sdf(pk, sdf_net, with_feature=False)
    return pk.done()


def pack_sdf_value(sdf_net):
    """(params (P,), offsets by name) for the value-sweep kernel."""
    return _cached(sdf_net, "_pack_sdf_value", (sdf_net,),
                   lambda: _pack_sdf_value(sdf_net))


def color_input_permutation(ccfg) -> list:
    """Kernel input row r takes original color-input row perm[r]: the
    original order is [x (4), PE(dirs), grad (4), feature]."""
    d_view = embed_dim(ccfg.multires_view, 3)
    o_dirs = ccfg.d_in - 7
    o_grad = o_dirs + d_view
    o_feat = o_grad + 4
    return (list(range(o_feat, o_feat + ccfg.d_feature)) + list(range(o_dirs))
            + list(range(o_dirs, o_grad)) + list(range(o_grad, o_feat)))


def _pack_rendercore(sdf_net, color_net):
    pk = _Packer()
    _add_sdf(pk, sdf_net, with_feature=True)
    ccfg = color_net.cfg
    n_c = len(ccfg.dims) - 1
    for l in range(n_c):
        layer = color_net.layers[f"lin{l}"]
        w = layer.effective_weight().t()               # (in, out)
        if l == 0:
            w = w[color_input_permutation(ccfg)]
            pad = color_k0(ccfg) - w.shape[0]
            if pad:
                w = torch.cat([w, w.new_zeros((pad, w.shape[1]))])
        pk.add("wc", w.contiguous())
        pk.add("bc", layer.b)
    return pk.done()


def pack_rendercore(sdf_net, color_net):
    """(params (P,), offsets by name) for the render-core forward kernel."""
    return _cached(sdf_net, "_pack_rendercore", (sdf_net, color_net),
                   lambda: _pack_rendercore(sdf_net, color_net))
