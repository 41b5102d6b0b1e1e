"""Host-side weight packing and geometry checks for the CUDA field kernels.

The kernels take every weight as one flat f32 buffer plus named float
offsets into it (the ``off_*`` arguments of the C entry points, which fill
``csrc/mlp_tile.cuh``'s ``Offsets``). This module alone decides the layout.
Weight norm is materialized here (``effective_layers``), as the JAX package
does outside its kernels (``sdf_kernels.py`` ``_prep``):

  * ``w[l]``, ``b[l]``: SDF hidden layer l, W_l (in, out) and b_l;
    ``wt[l]``: W_l^T (out, in) for the gradient and backward sweeps;
  * ``w_last0``, ``b_last0``: the last SDF layer's column 0 (hidden,) and
    its bias; ``w_feat``, ``b_feat``: its feature columns (hidden, d_feat)
    and their bias; ``w_feat_t``: the feature columns as (d_feat, hidden),
    for the backward;
  * ``wc[l]``, ``bc[l]``: color layer l (in, out); layer 0 has its input
    rows permuted to [feature, x, PE(dirs), grad] and zero-padded to k0 (a
    multiple of 4); ``wct[l]``: the same layer as (out, in), for the color
    backward.

The render-core kernels (K1, and K6 with the consistency query folded in)
take the SDF and the color parts in one buffer; the outgrad kernels (K4)
and the SDF output kernels (K7) the SDF part with the feature columns; the
color kernels (K5) the color part alone.

The backward kernels write their weight gradients into one flat buffer too
(``rendercore_grad_layout``, also K6-bwd's: the x rows and the y rows feed
the same SDF slots; ``outgrad_grad_layout``, ``color_grad_layout``,
``sdf_value_grad_layout``, also K7-bwd's with the whole head): per layer
the gradient of the effective W in the kernel's (out, in) layout (the color
layer 0 with the permuted, padded inputs of ``wct[0]``) and of b.
``unpack_*_grads`` map it back to each layer's effective (W (out, in), b).

A pack is cached on the network it belongs to (the SDF network for a pack
of both), keyed by the storage and version of every parameter it reads, so
a render call packs once and an in-place update (an optimizer step) or a
move to another device repacks.
"""

from __future__ import annotations

import torch

from ...models.embedder import embed_dim

MAX_SDF_HIDDEN_LAYERS = 16   # mlp_tile.cuh kMaxSdfHidden
MAX_COLOR_LAYERS = 6         # mlp_tile.cuh kMaxColorLayers
MAX_WIDTH = 256              # shared-memory row buffers


def sdf_skip(cfg) -> int:
    return cfg.skip_in[0] if cfg.skip_in else -1


def sdf_geometry(cfg) -> tuple:
    """The C entry points' SDF geometry arguments: n_lin, d_in, multires,
    hidden, skip."""
    return (len(cfg.dims) - 1, cfg.d_in, cfg.multires, cfg.d_hidden,
            sdf_skip(cfg))


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


def color_geometry(ccfg) -> tuple:
    """The C entry points' color geometry arguments: d_feat, n_lin, hidden,
    multires, k0."""
    return (ccfg.d_feature, len(ccfg.dims) - 1, ccfg.d_hidden,
            ccfg.multires_view, color_k0(ccfg))


def check_outgrad_geometry(cfg) -> None:
    """Raise for an SDF config the outgrad kernels (K4) do not take: the
    value kernels' geometry plus a feature head of a multiple of 4 columns
    <= 256."""
    check_sdf_geometry(cfg)
    d_feat = cfg.d_out - 1
    if d_feat < 4 or d_feat > MAX_WIDTH or d_feat % 4:
        raise ValueError("SDF config not supported by the outgrad kernels: "
                         f"d_out - 1 = {d_feat} must be a multiple of 4 in "
                         f"[4, {MAX_WIDTH}]")


def _color_problems(ccfg) -> list:
    problems = []
    if ccfg.mode != "idr":
        problems.append("only mode idr")
    if ccfg.d_in != 11 or ccfg.d_out != 3:
        problems.append("d_in must be 11 and d_out 3")
    if ccfg.d_feature > MAX_WIDTH or ccfg.d_feature % 4:
        problems.append(f"d_feature must be a multiple of 4 <= {MAX_WIDTH}")
    if ccfg.d_hidden > MAX_WIDTH or ccfg.d_hidden % 4:
        problems.append(f"d_hidden must be a multiple of 4 <= {MAX_WIDTH}")
    if len(ccfg.dims) - 1 > MAX_COLOR_LAYERS:
        problems.append(f"more than {MAX_COLOR_LAYERS} layers")
    return problems


def check_color_mlp_geometry(ccfg) -> None:
    """Raise for a color config the color kernels (K5) do not take. Either
    ray vector: the caller negates dirs and grad outside the kernel."""
    problems = _color_problems(ccfg)
    if problems:
        raise ValueError("color config not supported by the color kernels: "
                         + "; ".join(problems))


def check_color_geometry(sdf_cfg, ccfg) -> None:
    """Raise for a color config the render-core kernels (K1) do not take:
    the idr mode with a positive ray vector, its feature the SDF head's."""
    problems = _color_problems(ccfg)
    if ccfg.use_negative_ray_vector:
        problems.append("a positive ray vector only (the negative one "
                        "composes the outgrad and color kernels)")
    if ccfg.d_feature != sdf_cfg.d_out - 1:
        problems.append("d_feature must be sdf d_out - 1")
    if problems:
        raise ValueError("color config not supported by the render-core "
                         "kernels: " + "; ".join(problems))


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


_PER_LAYER = ("w", "b", "wt", "wc", "wct", "bc")


def effective_layers(net) -> list:
    """[(W (out, in), b (out,))] of every linear layer of ``net``, in order."""
    return [(layer.effective_weight(), layer.b)
            for layer in (net.layers[f"lin{l}"]
                          for l in range(len(net.cfg.dims) - 1))]


def _add_sdf(pk: _Packer, layers, with_feature: bool, with_wt: bool) -> None:
    for w, b in layers[:-1]:                           # w (out, in)
        pk.add("w", w.t().contiguous())
        pk.add("b", b)
        if with_wt:
            pk.add("wt", w)
    w, b = layers[-1]                                  # (d_out, hidden)
    pk.add("w_last0", w[0])
    pk.add("b_last0", b[:1])
    if with_feature:
        pk.add("w_feat", w[1:].t().contiguous())
        pk.add("b_feat", b[1:])
        pk.add("w_feat_t", w[1:])


def _cached(owner, name: str, nets, make):
    """``make()``, kept on ``owner`` and reused while no parameter of
    ``nets`` was replaced or modified in place since the last call."""
    key = tuple((p.data_ptr(), p._version) for net in nets
                for p in net.parameters())
    hit = owner.__dict__.get(name)
    if hit is not None and hit[0] == key:
        return hit[1]
    with torch.no_grad():
        packed = make()
    owner.__dict__[name] = (key, packed)
    return packed


def pack_sdf_value_layers(layers, with_wt: bool = False):
    """(params (P,), offsets by name) for the value kernels, from the SDF
    net's effective layers; ``with_wt`` adds the W^T the backward needs."""
    pk = _Packer()
    _add_sdf(pk, layers, with_feature=False, with_wt=with_wt)
    return pk.done()


def pack_sdf_value(sdf_net):
    """``pack_sdf_value_layers`` of ``sdf_net``, cached on the net."""
    return _cached(sdf_net, "_pack_sdf_value", (sdf_net,),
                   lambda: pack_sdf_value_layers(effective_layers(sdf_net)))


def color_input_permutation(ccfg) -> list:
    """Kernel input row r takes original color-input row perm[r]: the
    original order is [x (4), PE(dirs), grad (4), feature]."""
    d_view = embed_dim(ccfg.multires_view, 3)
    o_dirs = ccfg.d_in - 7
    o_grad = o_dirs + d_view
    o_feat = o_grad + 4
    return (list(range(o_feat, o_feat + ccfg.d_feature)) + list(range(o_dirs))
            + list(range(o_dirs, o_grad)) + list(range(o_grad, o_feat)))


def color_kernel_inputs(w: torch.Tensor, ccfg) -> torch.Tensor:
    """Color layer 0's (out, in) matrix with its input columns in the
    kernel's order and zero-padded to k0: (out, k0)."""
    w = w[:, color_input_permutation(ccfg)]
    pad = color_k0(ccfg) - w.shape[1]
    return torch.cat([w, w.new_zeros((w.shape[0], pad))], 1) if pad else w


def _add_color(pk: _Packer, color_layers, ccfg) -> None:
    for l, (w, b) in enumerate(color_layers):          # w (out, in)
        if l == 0:
            w = color_kernel_inputs(w, ccfg)
        pk.add("wc", w.t().contiguous())
        pk.add("wct", w)
        pk.add("bc", b)


def pack_rendercore_layers(sdf_layers, color_layers, ccfg):
    """(params (P,), offsets by name) for the render-core kernels, from the
    effective layers of both nets."""
    pk = _Packer()
    _add_sdf(pk, sdf_layers, with_feature=True, with_wt=True)
    _add_color(pk, color_layers, ccfg)
    return pk.done()


def pack_rendercore(sdf_net, color_net):
    """``pack_rendercore_layers`` of both nets, cached on the SDF net."""
    return _cached(sdf_net, "_pack_rendercore", (sdf_net, color_net),
                   lambda: pack_rendercore_layers(
                       effective_layers(sdf_net), effective_layers(color_net),
                       color_net.cfg))


def pack_outgrad_layers(sdf_layers):
    """(params (P,), offsets by name) for the outgrad kernels (K4): the SDF
    layers with W^T and the whole head (column 0, the feature columns both
    ways)."""
    pk = _Packer()
    _add_sdf(pk, sdf_layers, with_feature=True, with_wt=True)
    return pk.done()


def pack_outgrad(sdf_net):
    """``pack_outgrad_layers`` of ``sdf_net``, cached on the net."""
    return _cached(sdf_net, "_pack_outgrad", (sdf_net,),
                   lambda: pack_outgrad_layers(effective_layers(sdf_net)))


def pack_color_layers(color_layers, ccfg):
    """(params (P,), offsets by name) for the color kernels (K5): ``wc``,
    ``wct``, ``bc`` per layer, layer 0 in the kernel's input order."""
    pk = _Packer()
    _add_color(pk, color_layers, ccfg)
    return pk.done()


def pack_color(color_net):
    """``pack_color_layers`` of ``color_net``, cached on the net."""
    return _cached(color_net, "_pack_color", (color_net,),
                   lambda: pack_color_layers(effective_layers(color_net),
                                             color_net.cfg))


# ---------------------------------------------------------------------------
# Weight-gradient buffers of the backward kernels
# ---------------------------------------------------------------------------

def _layer_shapes(cfg) -> list:
    """(out, in) of every linear layer of an IDR MLP config."""
    from ...models.fields import idr_layer_dims

    if not hasattr(cfg, "skip_in"):                    # the color MLP
        return [(cfg.dims[l + 1], cfg.dims[l]) for l in range(len(cfg.dims) - 1)]
    return [tuple(reversed(idr_layer_dims(cfg, l)))
            for l in range(len(cfg.dims) - 1)]


class _GradLayout:
    def __init__(self):
        self.offs = {}
        self.size = 0

    def put(self, name: str, numel: int, per_layer: bool = True) -> None:
        if per_layer:
            self.offs.setdefault(name, []).append(self.size)
        else:
            self.offs[name] = self.size
        self.size += numel + (-numel) % 4


def _put_sdf(lay: _GradLayout, scfg, head_rows: int) -> None:
    shapes = _layer_shapes(scfg)
    shapes[-1] = (head_rows, shapes[-1][1])
    for o, i in shapes:
        lay.put("gw", o * i)
        lay.put("gb", o)


def sdf_value_grad_layout(scfg, head_rows: int = 1):
    """(offsets by name, size) of K3-bwd's gradient buffer: ``gw[l]``,
    ``gb[l]`` per SDF layer; the last layer holds its first ``head_rows``
    rows: row 0 for K3, all d_out for K7-bwd (``sdf_out``)."""
    lay = _GradLayout()
    _put_sdf(lay, scfg, head_rows)
    return lay.offs, lay.size


def _put_sdf_full(lay: _GradLayout, scfg) -> None:
    _put_sdf(lay, scfg, scfg.d_out)
    lay.put("gw_last0", scfg.d_hidden, per_layer=False)


def _put_color(lay: _GradLayout, ccfg) -> None:
    for l, (o, i) in enumerate(_layer_shapes(ccfg)):
        lay.put("gwc", o * (color_k0(ccfg) if l == 0 else i))
        lay.put("gbc", o)


def outgrad_grad_layout(scfg):
    """(offsets by name, size) of K4-bwd's gradient buffer: ``gw[l]``,
    ``gb[l]`` per SDF layer and ``gw_last0`` (hidden,), added to the last
    layer's row 0."""
    lay = _GradLayout()
    _put_sdf_full(lay, scfg)
    return lay.offs, lay.size


def color_grad_layout(ccfg):
    """(offsets by name, size) of K5-bwd's gradient buffer: ``gwc[l]``,
    ``gbc[l]`` per color layer (layer 0 as (out, k0) in the kernel's input
    order)."""
    lay = _GradLayout()
    _put_color(lay, ccfg)
    return lay.offs, lay.size


def rendercore_grad_layout(scfg, ccfg):
    """(offsets by name, size) of K1-bwd's gradient buffer: K4-bwd's SDF
    part, then K5-bwd's color part."""
    lay = _GradLayout()
    _put_sdf_full(lay, scfg)
    _put_color(lay, ccfg)
    return lay.offs, lay.size


def _take(buf, off, shape):
    n = 1
    for s in shape:
        n *= s
    return buf[off:off + n].view(shape)


def unpack_sdf_value_grads(buf, offs, scfg, head_rows: int = 1) -> list:
    """K3-bwd's buffer (K7-bwd's with ``head_rows`` d_out) -> [(W_bar
    (out, in), b_bar (out,))] per SDF layer; the last layer's rows past
    ``head_rows`` are zero."""
    shapes = _layer_shapes(scfg)
    out = []
    for l, (o, i) in enumerate(shapes):
        rows = head_rows if l == len(shapes) - 1 else o
        w = _take(buf, offs["gw"][l], (rows, i))
        b = _take(buf, offs["gb"][l], (rows,))
        if rows != o:
            w = torch.cat([w, w.new_zeros((o - rows, i))])
            b = torch.cat([b, b.new_zeros(o - rows)])
        out.append((w, b))
    return out


def unpack_outgrad_grads(buf, offs, scfg) -> list:
    """K4-bwd's buffer (or K1-bwd's SDF part) -> [(W_bar (out, in), b_bar)]
    per SDF layer, ``gw_last0`` added to the last layer's row 0."""
    sdf = [(_take(buf, offs["gw"][l], (o, i)), _take(buf, offs["gb"][l], (o,)))
           for l, (o, i) in enumerate(_layer_shapes(scfg))]
    w_last = sdf[-1][0].clone()
    w_last[0] += _take(buf, offs["gw_last0"], (scfg.d_hidden,))
    sdf[-1] = (w_last, sdf[-1][1])
    return sdf


def unpack_color_grads(buf, offs, ccfg) -> list:
    """K5-bwd's buffer (or K1-bwd's color part) -> [(W_bar (out, in),
    b_bar)] per color layer, layer 0 in its own input order."""
    color = []
    for l, (o, i) in enumerate(_layer_shapes(ccfg)):
        b = _take(buf, offs["gbc"][l], (o,))
        if l == 0:
            g = _take(buf, offs["gwc"][l], (o, color_k0(ccfg)))
            w = g.new_empty((o, i))
            w[:, color_input_permutation(ccfg)] = g[:, :i]
        else:
            w = _take(buf, offs["gwc"][l], (o, i))
        color.append((w, b))
    return color


def unpack_rendercore_grads(buf, offs, scfg, ccfg):
    """K1-bwd's buffer -> ([(W_bar, b_bar)] per SDF layer, [(W_bar, b_bar)]
    per color layer), each W_bar (out, in) in the layer's own input order."""
    return (unpack_outgrad_grads(buf, offs, scfg),
            unpack_color_grads(buf, offs, ccfg))


def _fill_sdf(buf, offs, sdf_bars) -> None:
    for l, (w, b) in enumerate(sdf_bars):
        buf[offs["gw"][l]:offs["gw"][l] + w.numel()] = w.reshape(-1)
        buf[offs["gb"][l]:offs["gb"][l] + b.numel()] = b


def _fill_color(buf, offs, color_bars, ccfg) -> None:
    for l, (w, b) in enumerate(color_bars):
        if l == 0:
            w = color_kernel_inputs(w, ccfg)
        buf[offs["gwc"][l]:offs["gwc"][l] + w.numel()] = w.reshape(-1)
        buf[offs["gbc"][l]:offs["gbc"][l] + b.numel()] = b


def pack_rendercore_grads(sdf_bars, color_bars, scfg, ccfg) -> torch.Tensor:
    """The inverse of ``unpack_rendercore_grads`` with ``gw_last0`` zero:
    per-layer (W_bar, b_bar) lists -> the kernel's gradient buffer."""
    offs, size = rendercore_grad_layout(scfg, ccfg)
    buf = sdf_bars[0][0].new_zeros(size)
    _fill_sdf(buf, offs, sdf_bars)
    _fill_color(buf, offs, color_bars, ccfg)
    return buf


def pack_outgrad_grads(sdf_bars, scfg) -> torch.Tensor:
    """The inverse of ``unpack_outgrad_grads`` with ``gw_last0`` zero."""
    offs, size = outgrad_grad_layout(scfg)
    buf = sdf_bars[0][0].new_zeros(size)
    _fill_sdf(buf, offs, sdf_bars)
    return buf


def pack_color_grads(color_bars, ccfg) -> torch.Tensor:
    """The inverse of ``unpack_color_grads``."""
    offs, size = color_grad_layout(ccfg)
    buf = color_bars[0][0].new_zeros(size)
    _fill_color(buf, offs, color_bars, ccfg)
    return buf
