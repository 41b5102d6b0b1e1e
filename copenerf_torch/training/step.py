"""The stage-1 / stage-2 train step (port of
``copenerf_tpu/training/step.py``): patch sampling -> rays -> render ->
losses -> gradients -> two Adam updates.

Gradient flow matches the reference as the JAX package has it: the field
optimizer covers sdf + color + variance, the motion optimizer the motion
net (stage 1 with ``train_motion``); the background NeRF is never
optimized; render weights are detached in the sdf-flow loss; the
sdf-consistency pose chain is detached unless ``sdf_cons_pose_grad``.
The stage-1 auxiliary losses share one full-video motion-chain
integration per step.

On a CUDA device the step runs the port's kernels: four value sweeps
(K2), the render-core forward and backward (K1-fwd, K1-bwd) and the
sdf-consistency value query and its backward (K3-fwd, K3-bwd). Passing
``device="cpu"`` tensors takes the kernels' plain versions.

With a process group (``build_train_step(..., group=...)``) the step is
data-parallel, one process per card: every rank draws the global batch
from the same generator and keeps its contiguous slice of whole patches,
computes its share of the global loss (means over the global batch; the
ratio terms' detached denominators summed over the ranks before the
division), and the gradients of the optimized parameters are summed by one
all-reduce of a flat bucket, so every rank takes the single-device step of
the global batch, to f32 summation order. The JAX package gets the same
from sharding constraints on one program (``mesh=``).
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from ..models.exchange import params_from_jax, params_to_jax
from ..models.fields import VarianceNetwork, motion_apply
from ..ops.interp import warp_pixels
from ..ops.rays import rays_from_pixels
from ..ops.renderer import RendererConfig, render
from ..parallel.distributed import (all_reduce_, all_reduce_grads_, rank,
                                    world_size)
from ..parallel.mesh import shard_rays
from ..poses.lie import se3_inverse
from ..poses.motion import full_video_w2c
from ..utils.profiling import span, spanned
from ..utils.tensors import constant, scalar, take
from .losses import (edge_aware_smoothness_loss, eikonal_loss, rgb_l1_loss,
                     sdf_flow_loss, smoothness_loss)

FIELD_NETS = ("sdf", "color", "variance")
# The networks each optimizer covers, by its key in the train state.
OPTIMIZER_NETS = {"opt_fields": FIELD_NETS, "opt_motion": ("motion",)}


@dataclasses.dataclass(frozen=True)
class StepStatic:
    """Static switches of the train step."""
    h: int
    w: int
    patch_size: int
    n_points: int
    stage1: bool
    n_images: int
    nb_sample_timestep: int
    n_ref: int
    train_motion: bool
    sdf_cons_pose_grad: bool
    use_flow_rgb: bool
    use_sdf_consistency: bool
    use_importance: bool = True
    smooth_scale: int = 1  # coarse-to-fine scale s; losses scaled 1/2^s
    # Take ray indices and stratified jitter from the batch ("ray_idx",
    # "t_rand") instead of the generator: the parity tests' hook.
    inject_sampling: bool = False


def sample_patch_indices(generator, h: int, w: int, patch_size: int,
                         n_points: int, device="cuda") -> torch.Tensor:
    """Flat ray indices (n_points,) of n_points / patch_size^2 whole
    patches whose top-left corners are a uniform subset, without
    repetition, of the (h - ps + 1) x (w - ps + 1) possible ones: the
    corners are the top-k of uniform draws from ``generator``."""
    ps = patch_size
    n_patches = n_points // (ps * ps)
    h_adj, w_adj = h - ps + 1, w - ps + 1
    z = torch.rand(h_adj * w_adj, generator=generator, device=device)
    corners = torch.topk(z, n_patches, sorted=False).indices
    start = (corners // w_adj) * w + corners % w_adj
    off = torch.arange(ps, device=device)
    offsets = (off[None, :] + off[:, None] * w).reshape(-1)
    return (start[:, None] + offsets[None, :]).reshape(-1)


def _gather_image(images_all: torch.Tensor, idx) -> torch.Tensor:
    """One (3, H, W) f32 image of the device-resident stack (uint8 or f32);
    ``idx`` an int or a one-element device tensor (``tensors.take``)."""
    img = take(images_all, idx)
    if img.dtype == torch.uint8:
        img = img.float() / 255.0
    return img


def _pixels_from_indices(ray_idx: torch.Tensor, h: int, w: int):
    """Flat indices -> ((x, y) float pixels, scaled pixels in [-1, 1])."""
    row = torch.div(ray_idx, w, rounding_mode="floor").float()
    col = (ray_idx % w).float()
    p = torch.stack([col, row], dim=-1)
    p_norm = torch.stack([2.0 * col / (w - 1) - 1.0,
                          2.0 * row / (h - 1) - 1.0], dim=-1)
    return p, p_norm


def make_loss_weights(rgb, eikonal, sdf, flow_rgb, sdf_consistency,
                      edge_smooth, smooth) -> dict:
    return {"rgb": float(rgb), "eikonal": float(eikonal), "sdf": float(sdf),
            "flow_rgb": float(flow_rgb),
            "sdf_consistency": float(sdf_consistency),
            "edge_smooth": float(edge_smooth), "smooth": float(smooth)}


def compute_losses(fields, rcfg: RendererConfig, s: StepStatic, batch: dict,
                   ray_idx: torch.Tensor, generator=None, t_rand=None,
                   group=None):
    """(total loss, metrics) of one step for explicit ray indices.

    ``fields`` is the ``ModuleDict`` of networks; ``batch`` holds the
    device-resident image stack and the step's scalars (see
    ``build_train_step``); ``t_rand`` (n, n_samples) overrides the
    stratified jitter, which otherwise comes from ``generator``.

    With ``group`` the rays are this rank's equal slice of whole patches of
    the global batch, and the loss and metrics are this rank's shares of the
    global ones: each mean is scaled by 1/world, and the denominators of
    the sdf-flow and flow-rgb ratios (detached) are summed over the ranks
    before the division. Their sums over the ranks are the global values,
    and so are the sums of the gradients."""
    dev = ray_idx.device
    world = world_size(group) if group is not None else 1

    def part(x):
        return x if world == 1 else x * (1.0 / world)

    with span("copenerf.step.sample"):
        p, p_norm = _pixels_from_indices(ray_idx, s.h, s.w)
        image_idx = batch["image_idx"]
        image = _gather_image(batch["images_all"], image_idx)
        rgb_gt = image.reshape(3, s.h * s.w)[:, ray_idx].T      # (N, 3)
        rays_o, rays_d, rays_d_norm = rays_from_pixels(
            p_norm, take(batch["K_all"], image_idx), batch["world_mat"],
            batch["scale_mat"])
        n = rays_o.shape[0]
        ones = torch.ones((n, 1), dtype=torch.float32, device=dev)
        near, far = ones * batch["near"], ones * batch["far"]

    cons = None
    w2c_all = inv_here = None
    if s.stage1 and (s.use_flow_rgb or s.use_sdf_consistency):
        with span("copenerf.step.motion"):
            w2c_all = full_video_w2c(fields["motion"], s.n_images,
                                     s.nb_sample_timestep)
            inv_here = se3_inverse(take(w2c_all, image_idx))
            if s.use_sdf_consistency:
                cw2 = take(w2c_all, batch["world_cam_idx"]) @ inv_here
                if not s.sdf_cons_pose_grad:
                    cw2 = cw2.detach()
                cons = (cw2, batch["world_time_step"])

    out = render(fields, rays_o, rays_d, rays_d_norm, batch["query_time_step"],
                 near, far, rcfg=rcfg,
                 cos_anneal_ratio=batch["cos_anneal_ratio"],
                 use_importance=s.use_importance, train=True,
                 generator=generator, t_rand=t_rand, cons=cons)
    with span("copenerf.step.losses"):
        w = batch["loss_weights"]
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        rgb_loss = part(rgb_l1_loss(out["color_fine"], rgb_gt))
        l2_mean = part(torch.mean((out["color_fine"] - rgb_gt) ** 2))
        eik_loss = part(eikonal_loss(out["normals"]))
        sdf_loss = flow_rgb_loss = sdf_cons_loss = zero
        edge_loss = smooth_loss = zero

        if s.stage1:
            pts = out["sampled_points"].reshape(-1, 3)
            t_q = scalar(batch["query_time_step"], torch.float32,
                         dev).reshape(1, 1)
            omega, vel = motion_apply(fields["motion"], t_q)
            scene_flow = (torch.cross(omega[0].expand(pts.shape), pts, dim=-1)
                          + vel[0])
            weights_flat = out["weights"].reshape(-1)
            # Per reference frame: (weighted L1 sum, valid-pixel count).
            refs = []

            if s.use_flow_rgb or s.use_sdf_consistency:
                # The reference computes this block only when the reference
                # list is non-empty.
                any_ref = torch.max(batch["ref_in_list"]) > 0
                if s.use_sdf_consistency:
                    active = any_ref & (image_idx != batch["world_cam_idx"])
                    sdf_cons_loss = torch.where(
                        active, part(torch.mean(torch.abs(
                            out["sdf_world"].reshape(-1)
                            - out["sdf"].reshape(-1)))),
                        zero)
                if s.use_flow_rgb:
                    ray_weights = out["weights"][..., None]       # (N, S, 1)
                    pts_r = out["sampled_points"]                 # (N, S, 3)
                    size = constant((float(s.w), float(s.h)), torch.float32,
                                    dev)

                    def one_ref(t):
                        ref_idx = torch.clamp(batch["ref_idxs"][t], 0,
                                              s.n_images - 1)
                        w2c_t = take(w2c_all, ref_idx) @ inv_here
                        pts_map = pts_r @ w2c_t[:3, :3].T + w2c_t[:3, 3]
                        wpm = torch.sum(ray_weights * pts_map, dim=1)  # (N, 3)
                        proj = (batch["scale_mat"][:3, :3]
                                @ take(batch["K_all"], ref_idx)[:3, :3])
                        pix = wpm @ proj.T
                        z = pix[:, 2:]
                        z_safe = torch.where(
                            torch.abs(z) < 1e-8,
                            torch.where(z < 0, -1e-8, 1e-8), z)
                        flow = (pix[:, :2] / z_safe - p_norm) * (size / 2.0)
                        corr = p + flow
                        in_bounds = ((corr >= 0).all(dim=1)
                                     & (corr < size).all(dim=1))
                        valid = (in_bounds.float()
                                 * batch["ref_valid_flow"][t]).detach()[:, None]
                        warped = warp_pixels(
                            _gather_image(batch["images_all"], ref_idx), corr,
                            normalize=True)
                        return (
                            torch.sum(torch.abs(warped - rgb_gt) * valid),
                            torch.sum(valid))

                    refs = [one_ref(t) for t in range(s.n_ref)]

            # The ratios' denominators, over every rank's rays before
            # dividing.
            weight_sum = None
            dens = [den for _, den in refs]
            if group is not None:
                sums = all_reduce_(torch.stack(
                    [torch.sum(weights_flat.detach())] + dens), group)
                weight_sum, dens = sums[0], list(sums[1:])
            sdf_loss = sdf_flow_loss(scene_flow, out["normals"],
                                     out["sdf_flows"], weights_flat,
                                     weight_sum)
            if refs:
                losses_t = torch.stack([num / (den + 1e-10) for (num, _), den
                                        in zip(refs, dens)])
                flow_rgb_loss = torch.where(
                    any_ref, torch.sum(losses_t) / 3.0, zero)

        ps = s.patch_size
        if ps > 1:
            n_patches = n // (ps * ps)
            disp = out["depth_pred"].reshape(n_patches, ps, ps, 1)
            rgb_grid = rgb_gt.reshape(n_patches, ps, ps, 3)
            scale = 1.0 / (2 ** s.smooth_scale)
            edge_loss = scale * part(edge_aware_smoothness_loss(disp,
                                                                rgb_grid))
            smooth_loss = scale * part(smoothness_loss(disp))

        total = (w["rgb"] * rgb_loss + w["eikonal"] * eik_loss
                 + w["sdf"] * sdf_loss + w["flow_rgb"] * flow_rgb_loss
                 + w["sdf_consistency"] * sdf_cons_loss
                 + w["edge_smooth"] * edge_loss + w["smooth"] * smooth_loss)
        metrics = {
            "loss": total, "loss_rgb": rgb_loss, "loss_eikonal": eik_loss,
            "l2_mean": l2_mean, "loss_sdf": sdf_loss,
            "loss_flow_rgb": flow_rgb_loss,
            "sdf_consistency_loss": sdf_cons_loss,
            "edge_aware_smoothness_loss": edge_loss,
            "smoothness_loss": smooth_loss,
            "s_val": part(torch.mean(out["s_val"])),
            "cdf_fine": part(torch.mean(out["cdf_fine"])),
            "weight_sum": part(torch.mean(out["weight_sum"])),
            "weight_max": part(torch.mean(out["weight_max"])),
            "psnr": _psnr(l2_mean),
        }
        return total, metrics


def _psnr(l2_mean):
    return -10.0 * torch.log10(torch.clamp(l2_mean, min=1e-10))


def _sum_metrics(metrics: dict, group) -> dict:
    """Every rank's metric shares summed by one all-reduce (on the device,
    no host copy); the psnr of the global l2_mean."""
    names = [k for k in metrics if k != "psnr"]
    sums = all_reduce_(torch.stack([metrics[k].detach() for k in names]),
                       group)
    out = dict(zip(names, sums.unbind()))
    out["psnr"] = _psnr(out["l2_mean"])
    return out


def _adam(params):
    return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)


def init_train_state(fields) -> dict:
    """The networks and two Adam optimizers (b1 0.9, b2 0.999, eps 1e-8):
    ``opt_fields`` over sdf + color + variance, ``opt_motion`` over the
    motion net. Learning rates are set from the batch on every step."""
    return {
        "fields": fields,
        "opt_fields": _adam([p for k in FIELD_NETS
                             for p in fields[k].parameters()]),
        "opt_motion": _adam(list(fields["motion"].parameters())),
    }


def build_train_step(rcfg: RendererConfig, static: StepStatic, group=None):
    """Return ``step(state, batch, generator) -> metrics``: one update of
    ``state`` (``init_train_state``) in place.

    ``group`` None is the single-device step. With a process group
    (``parallel.distributed.process_group()``) the step is data-parallel:
    every rank draws the global batch of ``static.n_points`` rays (or takes
    the injected global ``ray_idx`` / ``t_rand``), keeps its contiguous
    slice, and returns the global metrics; ``n_points`` must split into
    whole patches over the ranks.

    ``batch``: ``images_all`` (F, 3, H, W) uint8 or f32, ``K_all`` (F, 4, 4),
    ``ref_idxs`` (n_ref,) int, ``ref_in_list`` and ``ref_valid_flow``
    (n_ref,) f32, ``scale_mat`` and ``world_mat`` (4, 4), ``image_idx`` and
    ``world_cam_idx`` (int tensors), ``query_time_step``,
    ``world_time_step``, ``near``, ``far``, ``cos_anneal_ratio``,
    ``loss_weights`` (``make_loss_weights``), and the learning rates ``lr``
    and ``motion_lr`` as floats; with ``inject_sampling`` also ``ray_idx``
    and ``t_rand``. ``generator`` (on the batch's device) draws the patches
    and the stratified jitter."""
    s = static
    world = world_size(group) if group is not None else 1
    me = rank(group) if group is not None else 0
    if group is not None and s.n_points % (world * s.patch_size ** 2):
        raise ValueError(
            f"n_points={s.n_points} does not split into whole "
            f"{s.patch_size}x{s.patch_size} patches over {world} ranks")
    # The stratified jitter's width, as ``render`` draws it.
    n_uniform = rcfg.n_samples + (0 if s.use_importance else rcfg.n_importance)

    @spanned("copenerf.step")
    def step(state: dict, batch: dict, generator=None) -> dict:
        fields = state["fields"]
        opts = (state["opt_fields"], state["opt_motion"])
        with span("copenerf.step.optimizer"):
            for opt, lr in zip(opts, (batch["lr"], batch["motion_lr"])):
                for pg in opt.param_groups:
                    pg["lr"] = float(lr)
                opt.zero_grad(set_to_none=True)
        with span("copenerf.step.sample"):
            if s.inject_sampling:
                ray_idx, t_rand = batch["ray_idx"], batch["t_rand"]
            else:
                ray_idx = sample_patch_indices(
                    generator, s.h, s.w, s.patch_size, s.n_points,
                    device=batch["images_all"].device)
                t_rand = None
                if group is not None:
                    # The global batch's jitter, the draw the single-device
                    # render makes next from the generator.
                    t_rand = torch.rand((s.n_points, n_uniform),
                                        generator=generator,
                                        device=ray_idx.device)
            if group is not None:
                ray_idx = shard_rays(ray_idx, me, world)
                t_rand = shard_rays(t_rand, me, world)
        total, metrics = compute_losses(fields, rcfg, s, batch, ray_idx,
                                        generator=generator, t_rand=t_rand,
                                        group=group)
        with span("copenerf.step.backward"):
            total.backward()
        if group is not None:
            with span("copenerf.step.allreduce"):
                stepped = opts if s.train_motion else opts[:1]
                all_reduce_grads_([p for opt in stepped
                                   for g in opt.param_groups
                                   for p in g["params"]], group)
                metrics = _sum_metrics(metrics, group)
        with span("copenerf.step.optimizer"):
            opts[0].step()
            if s.train_motion:
                opts[1].step()
        return {k: v.detach() for k, v in metrics.items()}

    return step


# ---------------------------------------------------------------------------
# The train state in the JAX package's layout
# ---------------------------------------------------------------------------

# optax's ``scale_by_adam`` state; a checkpoint stores it as a 3-tuple.
AdamState = collections.namedtuple("ScaleByAdamState", ["count", "mu", "nu"])


def _jax_order(fields, nets):
    """[(parameter, transposed)] in the order ``ravel_pytree`` flattens the
    JAX tree ``{net: params}``: dict keys sorted at every level (the nets;
    the layers by name as strings, so ``lin10`` before ``lin2``; the leaves
    ``b, g, v`` or ``b, w``). A JAX (in, out) matrix is the port's (out, in)
    one transposed, and is raveled row-major."""
    out = []
    for name in sorted(nets):
        net = fields[name]
        if isinstance(net, VarianceNetwork):
            out.append((net.variance, False))
            continue
        for lname in sorted(net.layers.keys()):
            layer = net.layers[lname]
            for leaf in sorted(n for n, _ in layer.named_parameters()):
                out.append((getattr(layer, leaf), leaf in ("v", "w")))
    return out


def _adam_to_jax(opt, fields, nets) -> AdamState:
    """One optimizer's moments as the JAX package's flat ``mu`` / ``nu`` and
    its ``count`` (torch's ``step``; 0 and zero moments before a step)."""
    counts, mu, nu = set(), [], []
    for p, transposed in _jax_order(fields, nets):
        st = opt.state.get(p)
        if st:
            counts.add(int(st["step"]))
            m, v = st["exp_avg"].detach().cpu(), st["exp_avg_sq"].detach().cpu()
        else:
            counts.add(0)
            m = v = torch.zeros(p.shape, dtype=torch.float32)
        for flat, t in ((mu, m), (nu, v)):
            flat.append((t.T if transposed else t).reshape(-1).numpy())
    if len(counts) > 1:
        raise ValueError(f"parameters of {nets} took different numbers of "
                         f"Adam steps: {sorted(counts)}")
    return AdamState(np.asarray(counts.pop(), np.int32),
                     np.concatenate(mu).astype(np.float32),
                     np.concatenate(nu).astype(np.float32))


def _adam_from_jax(opt, fields, nets, adam_state) -> None:
    count, mu, nu = adam_state
    order = _jax_order(fields, nets)
    size = sum(p.numel() for p, _ in order)
    if np.size(mu) != size or np.size(nu) != size:
        raise ValueError(f"Adam moments of {nets} hold {np.size(mu)} / "
                         f"{np.size(nu)} entries, the parameters {size}")
    off = 0
    for p, transposed in order:
        n = p.numel()
        shape = (p.shape[1], p.shape[0]) if transposed else tuple(p.shape)

        def moment(flat):
            t = torch.from_numpy(np.array(flat[off:off + n], np.float32))
            t = t.reshape(shape)
            return (t.T if transposed else t).contiguous().to(p.device)

        opt.state[p] = {"step": torch.tensor(float(count), dtype=torch.float32),
                        "exp_avg": moment(np.ravel(mu)),
                        "exp_avg_sq": moment(np.ravel(nu))}
        off += n


def train_state_to_jax(state: dict) -> dict:
    """The JAX package's train state (``init_train_state`` after
    ``jax.device_get``) of the port's: ``{"params", "opt_fields",
    "opt_motion"}`` with numpy leaves, each optimizer one flat ``mu`` and
    ``nu`` over its networks and an int32 ``count``."""
    fields = state["fields"]
    tree = {"params": params_to_jax(fields)}
    for key, nets in OPTIMIZER_NETS.items():
        tree[key] = _adam_to_jax(state[key], fields, nets)
    return tree


def train_state_from_jax(tree: dict, configs: dict, device="cuda") -> dict:
    """The port's train state (``init_train_state``) holding a JAX train
    state tree: the networks' weights and both optimizers' moments and step
    counts, so the next step continues where the JAX one would."""
    order = ("sdf", "motion", "color", "nerf", "variance")
    params = {k: tree["params"][k] for k in order if k in tree["params"]}
    state = init_train_state(params_from_jax(params, configs, device))
    for key, nets in OPTIMIZER_NETS.items():
        _adam_from_jax(state[key], state["fields"], nets, tree[key])
    return state


def _ravel_tree(tree) -> np.ndarray:
    if isinstance(tree, dict):
        return np.concatenate([_ravel_tree(tree[k]) for k in sorted(tree)])
    return np.asarray(tree).reshape(-1)


def migrate_train_state(state: dict) -> dict:
    """Upgrade a loaded checkpoint's optimizer states in place.

    Checkpoints written before the JAX package kept one flat vector per
    optimizer stored the Adam moments as per-leaf trees with the structure
    of the params subtree; raveling them with sorted keys gives the flat
    layout elementwise. Flat states pass through untouched."""
    for key in OPTIMIZER_NETS:
        st = state.get(key)
        if (isinstance(st, (tuple, list)) and len(st) == 3
                and isinstance(st[1], dict)):
            state[key] = (st[0], _ravel_tree(st[1]), _ravel_tree(st[2]))
    return state
