"""Host-side weight packing and geometry checks for the CUDA field kernels.

The kernels take every weight as one flat f32 buffer plus named float
offsets into it (the ``off_*`` arguments of the C entry points, which fill
``csrc/mlp_tile.cuh``'s ``Offsets``). This module alone decides the layout.
Weight norm is materialized here (``effective_layers``), as the JAX package
does outside its kernels (``sdf_kernels.py`` ``_prep``):

  * ``b[l]``: SDF hidden layer l's bias b_l;
  * ``w_last0``, ``b_last0``: the last SDF layer's column 0 (hidden,) and
    its bias; ``b_feat``: its feature columns' bias;
  * ``wp[l]``, ``wtp[l]``: W_l and W_l^T as the wgmma core's B operand
    (``wg_pack_b``), for every SDF kernel (K1-K4, K6, K7); ``wfp``,
    ``wftp`` (the outgrad and render-core packs): the feature columns
    (hidden, d_feat) and their transpose as wgmma B;
  * ``bc[l]``: color layer l's bias; ``wcp[l]``, ``wctp[l]`` (the color
    and render-core packs, hidden layers): W_l and W_l^T as wgmma B, layer
    0 with its input rows permuted to [feature, x, PE(dirs), grad] and
    zero-padded to k0, a multiple of 4 (``wctp[0]`` its columns < 256,
    ``wct0tp`` the rest when k0 > 256: h0_bar's second pass);
    ``wc_last``, ``wct_last``: the 3-wide head both ways, plain.

The render-core kernels (K1, and K6 with the consistency query folded in)
take the SDF and the color parts in one buffer; the outgrad kernels (K4)
and the SDF output kernels (K7) the SDF part with the feature columns; the
color kernels (K5) the color part alone; the value kernels (K2, K3) the
SDF part without the feature columns. No pack carries a plain copy of a
hidden layer.

The backward kernels write their weight gradients into one flat buffer too
(``rendercore_grad_layout``, also K6-bwd's: the x rows and the y rows feed
the same SDF slots; ``outgrad_grad_layout``, ``color_grad_layout``,
``sdf_value_grad_layout``, also K7-bwd's with the whole head): per layer
the gradient of the effective W in the kernel's (out, in) layout (the color
layer 0 with the permuted, padded inputs of ``wctp[0]``) and of b.
``unpack_*_grads`` map it back to each layer's effective (W (out, in), b).

A pack is (params, ``Offsets``) and is cached on the network it belongs to
(the SDF network for a pack of both), keyed by the storage and version of
every parameter it reads, so a render call packs once and an in-place
update (an optimizer step) or a move to another device repacks. The
no-grad launches and the autograd.Functions read the same cached pack
(``apply_with_cached_pack``).
"""

from __future__ import annotations

import functools

import torch

from ...models.embedder import embed_dim
from ...utils.profiling import spanned
from . import build

MAX_SDF_HIDDEN_LAYERS = 16   # mlp_tile.cuh kMaxSdfHidden
MAX_COLOR_LAYERS = 6         # mlp_tile.cuh kMaxColorLayers
MAX_WIDTH = 256              # shared-memory row buffers
WG_SLICE_K = 32              # wgmma_tile.cuh kWgSliceK
WG_ROWS = 128                # columns of one warpgroup's product


def sdf_skip(cfg) -> int:
    return cfg.skip_in[0] if cfg.skip_in else -1


@functools.lru_cache
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


@functools.lru_cache
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


class Offsets(dict):
    """Float offsets by name (a list per layer for a per-layer name), each
    also made once as the C entry points take it: ``c(*names)``."""

    def __init__(self, offs):
        super().__init__(offs)
        self.c_args = {k: build.offsets(v) if isinstance(v, list) else v
                       for k, v in offs.items()}

    def c(self, *names) -> tuple:
        """The C arguments of ``names``: a per-layer list as a ``long long``
        array, 0 for a name the layout lacks."""
        return tuple(self.c_args.get(k, 0) for k in names)


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
        return torch.cat(self.parts).contiguous(), Offsets(self.offs)


_PER_LAYER = ("b", "wp", "wtp", "bc", "wcp", "wctp")


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 explicit mantissa bits, nearest, ties away from
    zero), as ``cvt.rna.tf32.f32`` rounds it."""
    bits = x.contiguous().view(torch.int32)
    finite = (bits & 0x7F800000) != 0x7F800000
    bits = torch.where(finite, bits + 0x1000, bits) & ~0x1FFF
    return bits.view(torch.float32)


_WG_INDEX = {}


def _wg_index(shapes, device):
    """(flat indices, lo mask) that gather the packed B of every (N, K,
    transposed) in ``shapes`` at once from the concatenation of their flat
    source matrices and one trailing zero (every padding position reads
    it): B^T (N, K) is the source itself, or its transpose when
    ``transposed`` (the source then (K, N)). Order per matrix: (slice, part,
    row n, stored position p), the two parts (hi and lo) gathering the same
    values; the mask marks the lo part."""
    key = (tuple(shapes), str(device))
    if key in _WG_INDEX:
        return _WG_INDEX[key]
    idx, lo, base = [], [], 0
    for N, K, transposed in shapes:
        n_pad = -(-N // WG_ROWS) * WG_ROWS
        n_sl = -(-K // WG_SLICE_K)
        n = torch.arange(n_pad)[:, None]
        p = torch.arange(WG_SLICE_K)[None, :]
        pl = ((p // 4) ^ (n % 8)) * 4 + p % 4     # the 128-byte swizzle undone
        b, h, kk = pl // 16, (pl % 16) // 8, pl % 8
        k_in = 16 * b + 4 * (kk % 4) + 2 * h + kk // 4
        k = torch.arange(n_sl)[:, None, None] * WG_SLICE_K + k_in   # (slices, n, p)
        nn = n.expand(n_pad, WG_SLICE_K)[None]
        src = base + (k * N + nn if transposed else nn * K + k)
        one = torch.where((k < K) & (nn < N), src, -1)[:, None]
        one = one.expand(n_sl, 2, n_pad, WG_SLICE_K)
        idx.append(one.reshape(-1))
        lo.append((torch.arange(2)[None, :, None, None] == 1).expand_as(one).reshape(-1))
        base += N * K
    idx = torch.cat(idx)
    _WG_INDEX[key] = (torch.where(idx < 0, base, idx).to(device), torch.cat(lo).to(device))
    return _WG_INDEX[key]


def wg_pack_many(mats) -> list:
    """``wg_pack_b`` of several matrices in one gather: each entry (m,
    transposed) packs B^T = m (N, K), or m^T when ``transposed``."""
    shapes = [(*(m.shape[::-1] if t else m.shape), t) for m, t in mats]
    device = mats[0][0].device
    src = torch.cat([m.detach().reshape(-1).float() for m, _ in mats]
                    + [torch.zeros(1, device=device)])
    idx, lo_mask = _wg_index(shapes, device)
    out = src[idx]                   # per slice: (hi, lo) of the same values
    hi = tf32_rna(out)
    out = torch.where(lo_mask, tf32_rna(out - hi), hi)
    sizes = [2 * -(-N // WG_ROWS) * WG_ROWS * -(-K // WG_SLICE_K) * WG_SLICE_K
             for N, K, _ in shapes]
    return list(out.split(sizes))


def wg_pack_b(bt: torch.Tensor) -> torch.Tensor:
    """The B operand (K x N) of the wgmma core (``csrc/wgmma_tile.cuh``)
    given as bt = B^T (N, K): per 32-deep slice of K, the TF32 hi parts
    (hi = tf32(b)) then the lo parts (tf32(b - hi)), each N rows (N rounded
    up to 128, zero past N and past K) of 32 values. Within each 16-value
    block the order is the core's k permutation (position 8 h + kk holds
    k = 4 (kk % 4) + 2 h + kk // 4, matching A's float4 loads), and 16-byte
    chunk c of row n is stored at c ^ (n % 8) (the 128-byte swizzle)."""
    return wg_pack_many([(bt, False)])[0]


def wg_unpack_b(packed: torch.Tensor, K: int, N: int):
    """(hi, lo), each B (K, N), read back from ``wg_pack_b``'s layout at the
    start of ``packed``: the inverse of the packing, for checks of a pack."""
    idx, lo_mask = _wg_index([(N, K, False)], packed.device)
    seg = packed[:idx.numel()].float()
    parts = []
    for mask in (~lo_mask, lo_mask):
        bt = seg.new_zeros(N * K + 1)
        bt[idx[mask]] = seg[mask]            # padding lands on the last slot
        parts.append(bt[:-1].view(N, K).t())
    return tuple(parts)


@spanned("copenerf.pack")
def effective_layers(net) -> list:
    """[(W (out, in), b (out,))] of every linear layer of ``net``, in order."""
    return [(layer.effective_weight(), layer.b)
            for layer in (net.layers[f"lin{l}"]
                          for l in range(len(net.cfg.dims) - 1))]


def _add_sdf(pk: _Packer, layers, with_feature: bool) -> None:
    """The SDF part of a pack: per hidden layer b, W and W^T as wgmma B;
    the head's column 0 and its bias; with ``with_feature`` the feature
    columns' bias and their matrix both ways as wgmma B."""
    # The forward's B^T is W (out, in), the down-sweep's W^T.
    mats = [(w, t) for w, _ in layers[:-1] for t in (False, True)]
    if with_feature:              # the head's feature rows, both ways
        mats += [(layers[-1][0][1:], t) for t in (False, True)]
    wg = iter(wg_pack_many(mats))
    for _, b in layers[:-1]:
        pk.add("b", b)
        pk.add("wp", next(wg))
        pk.add("wtp", next(wg))
    w, b = layers[-1]                                  # (d_out, hidden)
    pk.add("w_last0", w[0])
    pk.add("b_last0", b[:1])
    if with_feature:
        pk.add("wfp", next(wg))
        pk.add("wftp", next(wg))
        pk.add("b_feat", b[1:])


def _cached(name: str, nets, layers, make):
    """``make(*layers)``, kept on ``nets[0]`` and reused while no parameter
    of ``nets`` was replaced or modified in place since the last call.
    ``layers``: the effective layers of each net the caller already holds,
    or None to compute them on a miss."""
    key = tuple((p.data_ptr(), p._version) for net in nets
                for p in net.parameters())
    hit = nets[0].__dict__.get(name)
    if hit is not None and hit[0] == key:
        return hit[1]
    with torch.no_grad():
        packed = make(*(layers or [effective_layers(net) for net in nets]))
    nets[0].__dict__[name] = (key, packed)
    return packed


def apply_with_cached_pack(function, nets, cached, *rows):
    """``function.apply(*cfgs, pack, *rows, *weights)`` for the kernels of
    ``nets``: the weights every effective W, then every b, of each net, so
    autograd carries the kernel's W-bars through weight norm; the pack
    ``cached(*nets, layers=...)``, the one the no-grad launches read,
    built on a miss from those same effective layers."""
    layers = [effective_layers(net) for net in nets]
    return function.apply(*(net.cfg for net in nets), cached(*nets, layers=layers),
                          *rows, *build.weight_args(*layers))


@spanned("copenerf.pack")
def pack_sdf_value_layers(layers):
    """(params (P,), offsets by name) for the value kernels (K2, K3-fwd and
    K3-bwd), from the SDF net's effective layers: W and W^T as the wgmma
    core's B (one gather)."""
    pk = _Packer()
    _add_sdf(pk, layers, with_feature=False)
    return pk.done()


def pack_sdf_value(sdf_net, layers=None):
    """``pack_sdf_value_layers`` of ``sdf_net``, cached on the net: a train
    step's K2 launches and its K3 share one pack."""
    return _cached("_pack_sdf_value", (sdf_net,), layers, pack_sdf_value_layers)


def color_input_permutation(ccfg) -> list:
    """Kernel input row r takes original color-input row perm[r]: the
    original order is [x (4), PE(dirs), grad (4), feature]."""
    d_view = embed_dim(ccfg.multires_view, 3)
    o_dirs = ccfg.d_in - 7
    o_grad = o_dirs + d_view
    o_feat = o_grad + 4
    return (list(range(o_feat, o_feat + ccfg.d_feature)) + list(range(o_dirs))
            + list(range(o_dirs, o_grad)) + list(range(o_grad, o_feat)))


_COLOR_INDEX = {}


def color_input_index(ccfg, device) -> tuple:
    """(``color_input_permutation`` as an int64 tensor on ``device``, its
    inverse), made once per (ccfg, device): a gather by them copies no
    index from the host, so it does not wait for the card."""
    key = (ccfg, str(device))
    if key not in _COLOR_INDEX:
        perm = torch.tensor(color_input_permutation(ccfg))
        _COLOR_INDEX[key] = (perm.to(device), torch.argsort(perm).to(device))
    return _COLOR_INDEX[key]


def color_kernel_inputs(w: torch.Tensor, ccfg) -> torch.Tensor:
    """Color layer 0's (out, in) matrix with its input columns in the
    kernel's order and zero-padded to k0: (out, k0)."""
    w = w.index_select(1, color_input_index(ccfg, w.device)[0])
    pad = color_k0(ccfg) - w.shape[1]
    return torch.cat([w, w.new_zeros((w.shape[0], pad))], 1) if pad else w


def _add_color(pk: _Packer, color_layers, ccfg) -> None:
    """The color part of a pack: each hidden layer as wgmma B both ways
    (one gather), layer 0 in the kernel's input order; the head plain both
    ways; ``bc`` per layer."""
    layers = [(color_kernel_inputs(w, ccfg) if l == 0 else w, b)    # w (out, in)
              for l, (w, b) in enumerate(color_layers)]
    # The forward's B^T is W (out, in), the backward's W^T; h0_bar (N = k0)
    # runs in passes of at most 256 columns, each with its own B.
    w0 = layers[0][0]
    mats = [(w0, False), (w0[:, :MAX_WIDTH], True)]
    if w0.shape[1] > MAX_WIDTH:
        mats.append((w0[:, MAX_WIDTH:], True))
    mats += [(w, t) for w, _ in layers[1:-1] for t in (False, True)]
    wg = iter(wg_pack_many(mats))
    for l, (_, b) in enumerate(layers[:-1]):
        pk.add("wcp", next(wg))
        pk.add("wctp", next(wg))
        if l == 0 and w0.shape[1] > MAX_WIDTH:
            pk.add("wct0tp", next(wg))
        pk.add("bc", b)
    w, b = layers[-1]                                  # (3, hidden)
    pk.add("wc_last", w.t().contiguous())
    pk.add("wct_last", w)
    pk.add("bc", b)


@spanned("copenerf.pack")
def pack_rendercore_layers(sdf_layers, color_layers, ccfg):
    """(params (P,), offsets by name) for the render-core kernels (K1, K6),
    from the effective layers of both nets: the outgrad pack's SDF part and
    the color pack's color part, no plain copy of any hidden layer."""
    pk = _Packer()
    _add_sdf(pk, sdf_layers, with_feature=True)
    _add_color(pk, color_layers, ccfg)
    return pk.done()


def pack_rendercore(sdf_net, color_net, layers=None):
    """``pack_rendercore_layers`` of both nets, cached on the SDF net."""
    return _cached("_pack_rendercore", (sdf_net, color_net), layers,
                   lambda s, c: pack_rendercore_layers(s, c, color_net.cfg))


@spanned("copenerf.pack")
def pack_outgrad_layers(sdf_layers):
    """(params (P,), offsets by name) for the outgrad kernels (K4) and the
    SDF output kernels (K7): the SDF layers and the whole head (column 0,
    the feature columns), the matrices only as the wgmma core's B both ways
    (one gather): no kernel of K4 or K7 reads a plain copy."""
    pk = _Packer()
    _add_sdf(pk, sdf_layers, with_feature=True)
    return pk.done()


def pack_outgrad(sdf_net, layers=None):
    """``pack_outgrad_layers`` of ``sdf_net``, cached on the net."""
    return _cached("_pack_outgrad", (sdf_net,), layers, pack_outgrad_layers)


@spanned("copenerf.pack")
def pack_color_layers(color_layers, ccfg):
    """(params (P,), offsets by name) for the color kernels (K5): each
    hidden layer packed for the wgmma core both ways (one gather), layer 0
    in the kernel's input order; the head plain both ways; ``bc`` per
    layer."""
    pk = _Packer()
    _add_color(pk, color_layers, ccfg)
    return pk.done()


def pack_color(color_net, layers=None):
    """``pack_color_layers`` of ``color_net``, cached on the net."""
    return _cached("_pack_color", (color_net,), layers,
                   lambda c: pack_color_layers(c, color_net.cfg))


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


@functools.lru_cache
def sdf_value_grad_layout(scfg, head_rows: int = 1):
    """(offsets by name, size) of K3-bwd's gradient buffer: ``gw[l]``,
    ``gb[l]`` per SDF layer; the last layer holds its first ``head_rows``
    rows: row 0 for K3, all d_out for K7-bwd (``sdf_out``)."""
    lay = _GradLayout()
    _put_sdf(lay, scfg, head_rows)
    return Offsets(lay.offs), lay.size


def _put_sdf_full(lay: _GradLayout, scfg) -> None:
    _put_sdf(lay, scfg, scfg.d_out)
    lay.put("gw_last0", scfg.d_hidden, per_layer=False)


def _put_color(lay: _GradLayout, ccfg) -> None:
    for l, (o, i) in enumerate(_layer_shapes(ccfg)):
        lay.put("gwc", o * (color_k0(ccfg) if l == 0 else i))
        lay.put("gbc", o)


@functools.lru_cache
def outgrad_grad_layout(scfg):
    """(offsets by name, size) of K4-bwd's gradient buffer: ``gw[l]``,
    ``gb[l]`` per SDF layer and ``gw_last0`` (hidden,), added to the last
    layer's row 0."""
    lay = _GradLayout()
    _put_sdf_full(lay, scfg)
    return Offsets(lay.offs), lay.size


@functools.lru_cache
def color_grad_layout(ccfg):
    """(offsets by name, size) of K5-bwd's gradient buffer: ``gwc[l]``,
    ``gbc[l]`` per color layer (layer 0 as (out, k0) in the kernel's input
    order)."""
    lay = _GradLayout()
    _put_color(lay, ccfg)
    return Offsets(lay.offs), lay.size


@functools.lru_cache
def rendercore_grad_layout(scfg, ccfg):
    """(offsets by name, size) of K1-bwd's gradient buffer: K4-bwd's SDF
    part, then K5-bwd's color part."""
    lay = _GradLayout()
    _put_sdf_full(lay, scfg)
    _put_color(lay, ccfg)
    return Offsets(lay.offs), lay.size


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
            w = g[:, :i].index_select(1, color_input_index(ccfg, g.device)[1])
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
