"""Data parallelism of the port (``copenerf_torch/parallel/``) on the CPU:
two ranks over Gloo against the single-device port and the JAX package's
sharded programs on the conftest's virtual CPU devices.

The ranks are processes that run this file as a script (``_rank_main``):
they import no JAX, meet through a ``FileStore`` under the test's temporary
directory and run one thread each. One launch of two ranks drives every
case; the test process writes their inputs (JAX-initialized weights,
numpy batches, injected global ``ray_idx`` / ``t_rand``, a synthetic scene)
and holds what they wrote against its own references:

  (a) the 2-rank step against JAX ``build_train_step(..., mesh=make_mesh(2))``
      (metrics) and the gradients of JAX ``compute_losses(..., mesh=...)``,
      stage 1 with flow-rgb and sdf-consistency, and stage 2: the bounds of
      ``test_torch_step.py`` (metrics 2e-5 relative + 1e-6; gradients 1e-3
      of each tensor's largest entry in stage 1, 2e-4 in stage 2, + 1e-6);
  (b) against the 1-rank port step on the global batch at the same weights
      (rank 0 computes it before each step): each gradient tensor within
      1e-5 of its largest entry, or within twice the most the 1-rank
      step's own gradient moves when the global batch's rays are merely
      put in another order that leaves the loss unchanged
      (``reorder_rows``, N_REORDERS orders), if that is more (+ 1e-7);
      metrics 1e-6 relative; after 3 steps both ranks' parameters bitwise
      equal. The second term is f32 summation order: the scalar variance
      gradient sums every sample's term, and reordering alone moves it by
      up to 2e-4 of itself at the first step and 2.2e-3 at the second,
      where it is 0.0027 of summands near 1;
  (c) a planted fault, each rank's loss with local denominators and the
      gradients averaged, fails (b)'s gradient bound by 10x;
  (d) the split render against the 1-rank render and JAX
      ``ImageRenderer(mesh=make_mesh(2))``, within
      ``test_torch_render_image.py``'s bounds;
  (e) a 2-rank ``Trainer`` through the stage-1 -> 2 transition (sampling
      from the (seed, it) generator, visualizations on) against the 1-rank
      one: the loss curve within ``test_torch_trainer.py``'s 3e-4
      relative, the refined poses within its 1e-4, equal on both ranks;
      rank 1 writes no file; then both ranks evaluate rank 0's run
      (``Evaluator.eval``: test poses optimized on every rank, rank 0's
      broadcast, the split render): rank 0's metrics equal a 1-rank
      Evaluator's on a copy of the run, rank 1 returns None;
  (f) the guards.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from copenerf_torch.config.loader import load_config  # noqa: E402
from copenerf_torch.evaluation.render import ImageRenderer  # noqa: E402
from copenerf_torch.models import exchange as X  # noqa: E402
from copenerf_torch.models import fields as TF  # noqa: E402
from copenerf_torch.ops.kernels import build as KB  # noqa: E402
from copenerf_torch.ops.renderer import RendererConfig  # noqa: E402
from copenerf_torch.parallel import distributed as dist  # noqa: E402
from copenerf_torch.training import step as TS  # noqa: E402
from copenerf_torch.training.checkpoints import (_flatten,  # noqa: E402
                                                 load_pytree, save_pytree)
from copenerf_torch.training.trainer import Trainer  # noqa: E402

WORLD = 2
TIMEOUT = 240            # seconds a launch may take; its collectives' bound
H = W = 24
N_POINTS = 64            # 4 patches of 4x4: 2 a rank
STEPS = 3
# The nets of test_torch_step.py (step) and test_torch_render_image.py
# (render), as the port's configs.
STEP_CFGS = {
    "sdf": TF.SDFConfig(d_hidden=64, n_layers=4, skip_in=(2,), d_out=33),
    "color": TF.ColorConfig(d_feature=32, d_hidden=32, n_layers=2),
    "motion": TF.MotionConfig(d_hidden=32, n_layers=2, skip_in=(1,)),
    "variance": TF.VarianceConfig(init_val=0.3),
    "nerf": TF.NerfConfig(D=2, W=32),
}
RENDER_CFGS = {
    "sdf": TF.SDFConfig(d_in=4, d_out=33, d_hidden=64, n_layers=4,
                        skip_in=(2,), multires=3),
    "color": TF.ColorConfig(d_feature=32, d_hidden=64, n_layers=3,
                            multires_view=2),
    "motion": TF.MotionConfig(d_hidden=32, n_layers=4, skip_in=(2,),
                              multires=3),
    "nerf": TF.NerfConfig(D=4, W=32, multires=3, multires_view=2,
                          skips=(2,)),
    "variance": TF.VarianceConfig(),
}
STEP_RCFG = dict(n_samples=16, n_importance=16, up_sample_steps=2)
RENDER_RCFG = dict(n_samples=16, n_importance=16, up_sample_steps=4)
RENDER_RES, RENDER_CHUNK = (6, 10), 16
RENDER_ARGS_KEYS = ("K", "world_mat", "scale_mat")
STAGES = {  # StepStatic switches, JAX gradient bound
    "stage1": (dict(stage1=True, train_motion=True, use_flow_rgb=True,
                    use_sdf_consistency=True), 1e-3),
    "stage2": (dict(stage1=False, train_motion=False, use_flow_rgb=False,
                    use_sdf_consistency=False), 2e-4),
}
DP_GRAD_RTOL, DP_METRIC_RTOL = 1e-5, 1e-6
N_REORDERS = 6


def reorder_rows(n: int, seed: int) -> torch.Tensor:
    """Rows of a batch of ``n`` rays in whole 4x4 patches (row-major within
    each) in another order that leaves the step's loss unchanged: the
    patches permuted, and each patch's 16 rays moved by one of the square's
    8 symmetries (the smoothness terms are symmetric under each)."""
    g = torch.Generator().manual_seed(seed)
    grid = torch.arange(16).reshape(4, 4)
    moves = [torch.rot90(grid, k, (0, 1)) for k in range(4)]
    moves += [m.T for m in moves]
    order = torch.randperm(n // 16, generator=g)
    pick = torch.randint(0, 8, (n // 16,), generator=g)
    return torch.cat([16 * int(q) + moves[int(d)].reshape(-1)
                      for q, d in zip(order, pick)])
LOSS_RTOL, POSE_ATOL = 3e-4, 1e-4


def static(stage, n_points=N_POINTS, inject=True):
    return TS.StepStatic(h=H, w=W, patch_size=4, n_points=n_points,
                         n_images=7, nb_sample_timestep=4, n_ref=3,
                         sdf_cons_pose_grad=False, inject_sampling=inject,
                         **STAGES[stage][0])


def torch_batch(nb: dict, k: int | None = None) -> dict:
    """The port's batch of the numpy one (``inputs["batch"]``), with step
    ``k``'s injected global sampling."""
    b = {key: torch.as_tensor(np.asarray(v)) for key, v in nb.items()
         if key not in ("weights", "lr", "motion_lr", "ray_idx", "t_rand")}
    for key in ("ref_idxs", "image_idx", "world_cam_idx"):
        b[key] = b[key].long()
    b["loss_weights"] = TS.make_loss_weights(*np.asarray(nb["weights"]))
    b["lr"], b["motion_lr"] = float(nb["lr"]), float(nb["motion_lr"])
    if k is not None:
        b["ray_idx"] = torch.from_numpy(np.asarray(nb["ray_idx"][k])).long()
        b["t_rand"] = torch.from_numpy(np.asarray(nb["t_rand"][k]))
    return b


def grads_tree(fields, nets) -> dict:
    """The gradients of ``nets`` in the JAX params layout."""
    out = {}
    for name in nets:
        g = copy.deepcopy(fields[name])
        for pg, p in zip(g.parameters(), fields[name].parameters()):
            pg.data = p.grad.detach().clone()
        out.update(X.params_to_jax(torch.nn.ModuleDict({name: g})))
    return out


def stepped_nets(stage):
    return TS.FIELD_NETS + (("motion",) if STAGES[stage][0]["train_motion"]
                            else ())


def trainer_cfg(scene, out_dir, **training) -> dict:
    """Small nets on a 6-frame 24x32 scene, across the transition at epoch
    1, visualizations every 4 iterations."""
    path, name = scene
    cfg = load_config(None)
    cfg["dataloading"].update({"path": path, "scene": [name]})
    cfg["rendering"]["depth_range"] = [0.5, 3.5]
    cfg["training"].update({
        "out_dir": out_dir, "original_resolution": [24, 32],
        "resolution": [24, 32], "vis_resolution": [12, 16],
        "n_training_points": 64, "patch_size": 4,
        "scheduling_start": 5, "scheduling_epoch": 3,
        "start_query_world_epoch": 1, "pose_refine_epochs": 20,
        "end_smooth_epoch": 100, "nb_warm_up_it": 10,
        "pretrained_sdf_path": None, "checkpoint_every": 100,
        "eval_pose_every": 1, "print_every": 5,
        "depth_bound_update_every_milestones": [4, 4, 4], **training})
    cfg["neus_sdf_network"].update({"d_hidden": 64, "n_layers": 4,
                                    "skip_in": [2], "d_out": 33})
    cfg["neus_rendering_network"].update({"d_feature": 32, "d_hidden": 32,
                                          "n_layers": 2})
    cfg["motion_network"].update({"d_hidden": 32, "n_layers": 2,
                                  "skip_in": [1]})
    cfg["neus_nerf"].update({"D": 2, "W": 32})
    cfg["neus_renderer"].update({"n_samples": 16, "n_importance": 16,
                                 "up_sample_steps": 2})
    return cfg


class RecordingTrainer(Trainer):
    """The port's ``Trainer`` keeping each iteration's loss (a device
    tensor, copied at the end)."""

    def _get_step(self, stage1, train_motion):
        inner = super()._get_step(stage1, train_motion)
        self.losses = getattr(self, "losses", [])

        def step(state, batch, generator):
            metrics = inner(state, batch, generator)
            self.losses.append(metrics["loss"])
            return metrics

        return step


def run_trainer(cfg) -> dict:
    t = RecordingTrainer(cfg, device="cpu", verbose=False)
    t.train(max_epochs=2)
    t.save_checkpoint()
    return {"losses": torch.stack(t.losses).numpy(),
            "poses": t.refined_c2w, "fell_back": int(t.pose_refine_fell_back),
            "params": X.params_to_jax(t.state["fields"])}


def eval_cfg(cfg, out_dir) -> dict:
    """``cfg`` evaluating the run in ``out_dir`` with 3 test-pose epochs."""
    return dict(cfg, training=dict(cfg["training"], out_dir=out_dir),
                eval=dict(cfg["eval"], eval_pose_epoch=3))


def run_evaluator(cfg):
    from copenerf_torch.evaluation.evaluator import Evaluator

    return Evaluator(cfg, device="cpu", verbose=False).eval()


def raises(fn, exc=ValueError) -> str:
    """``fn``'s error message; '' when it does not raise ``exc``."""
    try:
        fn()
    except exc as e:
        return str(e)
    return ""


# ---------------------------------------------------------------------------
# The ranks' program
# ---------------------------------------------------------------------------

def _dp_steps(inputs: dict, rank: int) -> dict:
    """Per stage, STEPS data-parallel steps from the exchanged weights;
    rank 0 also computes the single-device gradients and metrics of the
    global batch at each step's weights, and the planted fault's gradients
    at the first."""
    group = dist.process_group()
    rcfg = RendererConfig(**STEP_RCFG)
    nb = inputs["batch"]
    out = {}
    orders = [None] + [reorder_rows(N_POINTS, seed)
                       for seed in range(N_REORDERS)]
    for stage in STAGES:
        fields = X.params_from_jax(inputs["step_params"], STEP_CFGS, "cpu")
        state = TS.init_train_state(fields)
        step = TS.build_train_step(rcfg, static(stage), group=group)
        rec = {"metrics": [], "grads": [], "ref_metrics": [], "ref_grads": [],
               "reordered_grads": []}
        for k in range(STEPS):
            batch = torch_batch(nb, k)
            reordered = []
            for rows in orders if rank == 0 else []:
                rows = slice(None) if rows is None else rows
                ref = copy.deepcopy(fields)
                total, m = TS.compute_losses(ref, rcfg, static(stage), batch,
                                             batch["ray_idx"][rows],
                                             t_rand=batch["t_rand"][rows])
                total.backward()
                reordered.append(grads_tree(ref, stepped_nets(stage)))
                if len(reordered) == 1:
                    rec["ref_metrics"].append({n: float(v)
                                               for n, v in m.items()})
            if reordered:
                rec["ref_grads"].append(reordered[0])
                rec["reordered_grads"].append(reordered[1:])
            m = step(state, batch)
            rec["metrics"].append({key: float(v) for key, v in m.items()})
            rec["grads"].append(grads_tree(fields, stepped_nets(stage)))
        rec["params"] = X.params_to_jax(fields)
        out[stage] = rec
    # (c) each rank's loss as a single device would take it on its slice
    # (local means and denominators), the gradients averaged.
    fields = X.params_from_jax(inputs["step_params"], STEP_CFGS, "cpu")
    batch = torch_batch(nb, 0)
    n = N_POINTS // WORLD
    total, _ = TS.compute_losses(
        fields, rcfg, static("stage1", n_points=n), batch,
        batch["ray_idx"][rank * n:(rank + 1) * n],
        t_rand=batch["t_rand"][rank * n:(rank + 1) * n])
    total.backward()
    params = [p for k in stepped_nets("stage1") for p in fields[k].parameters()]
    dist.all_reduce_grads_(params, group)
    for p in params:
        p.grad /= WORLD
    out["fault_grads"] = grads_tree(fields, stepped_nets("stage1"))
    return out


def _split_render(inputs: dict) -> dict:
    fields = X.params_from_jax(inputs["render_params"], RENDER_CFGS, "cpu")
    r = ImageRenderer(RendererConfig(**RENDER_RCFG), chunk=RENDER_CHUNK,
                      device="cpu", group=dist.process_group())
    ra = inputs["render_args"]
    res = r.render_image(fields, *(ra[k] for k in RENDER_ARGS_KEYS),
                         float(ra["t"]), RENDER_RES, (0.5, 4.0), 0.6,
                         want_pts=True)
    return {**res, "chunks": np.asarray([r.min_chunk, r.chunk])}


def _guards(inputs: dict, cfg: dict) -> dict:
    group = dist.process_group()
    rcfg = RendererConfig(**STEP_RCFG)
    fields = X.params_from_jax(inputs["step_params"], STEP_CFGS, "cpu")
    if dist.rank() == 1:
        with torch.no_grad():
            fields["color"].layers["lin1"].b[0] += 1e-6
    return {
        "replicas": raises(lambda: dist.check_replicas(fields, group),
                           RuntimeError),
        "rays": raises(lambda: TS.build_train_step(
            rcfg, static("stage1", n_points=48), group=group)),
        "n_devices": raises(lambda: Trainer(
            dict(cfg, training=dict(cfg["training"], n_devices=1)),
            device="cpu", verbose=False)),
        "chunk": raises(lambda: ImageRenderer(
            rcfg, chunk=1, device="cpu", group=group)),
    }


def _jax_modules() -> list:
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "copenerf_tpu"))


def _single_main(work: str) -> None:
    """The 1-rank Trainer, in a process of its own as the ranks are: a
    Trainer's view order depends on whether this process imported
    TensorBoard before it (its import draws from ``np.random``)."""
    torch.set_num_threads(1)
    with open(os.path.join(work, "trainer.json")) as f:
        cfg = json.load(f)
    cfg["training"]["out_dir"] = os.path.join(work, "single")
    save_pytree(os.path.join(work, "single.npz"), run_trainer(cfg))


def _rank_main(work: str, rank: int) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(WORLD))
    torch.set_num_threads(1)
    dist.initialize("gloo", init_method="file://" + os.path.join(work, "store"),
                    timeout=TIMEOUT)
    inputs = load_pytree(os.path.join(work, "inputs.npz"))
    with open(os.path.join(work, "trainer.json")) as f:
        cfg = json.load(f)
    out = {"steps": _dp_steps(inputs, rank), "render": _split_render(inputs)}
    out["jax_modules_before_trainer"] = _jax_modules()
    cfg["training"]["out_dir"] = os.path.join(work, f"out{rank}")
    out["trainer"] = run_trainer(cfg)
    result = run_evaluator(eval_cfg(cfg, os.path.join(work, "out0")))
    out["eval"] = result if result is not None else {"returned_none": 1}
    out["guards"] = _guards(inputs, cfg)
    out["jax_modules_at_end"] = _jax_modules()
    save_pytree(os.path.join(work, f"rank{rank}.npz"), out)
    dist.barrier()
    torch.distributed.destroy_process_group()


def launch(work: str) -> list:
    """Run WORLD ranks of this file on ``work``, and the 1-rank Trainer
    beside them; their outputs (the ranks', then the Trainer's). A process
    that fails or outlasts TIMEOUT fails the launch (the others are
    killed)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    names = [str(r) for r in range(WORLD)] + ["single"]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), work, name], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name in names]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(n, p.returncode) for n, p in zip(names, procs) if p.returncode]
    assert not bad, f"processes failed {bad}:\n" + "\n".join(logs)
    return ([load_pytree(os.path.join(work, f"rank{r}.npz"))
             for r in range(WORLD)],
            load_pytree(os.path.join(work, "single.npz")))


# ---------------------------------------------------------------------------
# The test process: inputs, references, checks
# ---------------------------------------------------------------------------

def _jax():
    """The JAX side (imported here only: the ranks never import it)."""
    import jax
    from copenerf_tpu.models import fields as JF

    def jcfgs(cfgs):
        return {k: getattr(JF, type(v).__name__)(**dataclasses.asdict(v))
                for k, v in cfgs.items()}

    return jax, JF, jcfgs


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Inputs written, the two ranks and the 1-rank Trainer launched
    once."""
    import test_torch_step as TST

    from copenerf_torch.data.synthetic import make_scene

    jax, JF, jcfgs = _jax()
    work = str(tmp_path_factory.mktemp("dp"))
    nb = TST._np_batch()
    nb["weights"] = np.asarray(nb["weights"], np.float32)
    samples = [TST.sampling(5 + k) for k in range(STEPS)]
    nb["ray_idx"] = np.stack([s[0] for s in samples]).astype(np.int64)
    nb["t_rand"] = np.stack([s[1] for s in samples])
    step_params = jax.tree_util.tree_map(np.asarray, JF.init_all_fields(
        jax.random.PRNGKey(0), jcfgs(STEP_CFGS)))
    render_params = jax.tree_util.tree_map(np.asarray, JF.init_all_fields(
        jax.random.PRNGKey(2), jcfgs(RENDER_CFGS)))
    w2c = np.eye(4, dtype=np.float32)
    w2c[2, 3] = -2.0
    render_args = {
        "K": np.array([[1.6, 0, 0, 0], [0, -16.0 / 6, 0, 0], [0, 0, -1, 0],
                       [0, 0, 0, 1]], np.float32),
        "world_mat": w2c, "scale_mat": np.eye(4, dtype=np.float32),
        "t": np.float32(0.05)}
    inputs = {"batch": nb, "step_params": step_params,
              "render_params": render_params, "render_args": render_args}
    save_pytree(os.path.join(work, "inputs.npz"), inputs)
    scene = make_scene(os.path.join(work, "scene"), n_frames=6, h=24, w=32)
    with open(os.path.join(work, "trainer.json"), "w") as f:
        json.dump(trainer_cfg(scene, ""), f)
    ranks, single = launch(work)
    return {"work": work, "inputs": load_pytree(os.path.join(work, "inputs.npz")),
            "ranks": ranks, "single": single}


def assert_close_share(got: dict, ref: dict, rtol: float, atol: float, what):
    """Every leaf of two params-layout trees within ``rtol`` of the
    reference tensor's largest entry plus ``atol``."""
    from test_torch_step import assert_trees_close

    assert_trees_close(got, ref, rtol, atol, what)


def order_bounds(ref: dict, reordered: list) -> dict:
    """(b)'s bound per gradient tensor (flat paths): 1e-5 of its largest
    entry, or twice the most the 1-rank gradient moves under the patch
    reorderings."""
    ref, others = _flatten(ref), [_flatten(o) for o in reordered]
    return {k: max(DP_GRAD_RTOL * np.abs(r).max(),
                   2 * max(np.abs(o[k] - r).max() for o in others)) + 1e-7
            for k, r in ref.items()}


def excess(got: dict, ref: dict, bounds: dict) -> dict:
    """max |got - ref| over each tensor's bound, by flat path."""
    got, ref = _flatten(got), _flatten(ref)
    return {k: float(np.abs(got[k] - r).max() / bounds[k])
            for k, r in ref.items()}


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_dp_step_matches_jax_sharded_step(dp, stage):
    """(a) The first 2-rank step against the JAX package on a 2-device
    mesh: the metrics of ``build_train_step(..., mesh=...)`` and the
    gradients of ``compute_losses(..., mesh=...)``."""
    jax, JF, jcfgs = _jax()
    import jax.numpy as jnp
    from copenerf_tpu.ops.renderer import RendererConfig as JRendererConfig
    from copenerf_tpu.parallel.mesh import make_mesh
    from copenerf_tpu.training import step as JS
    from test_torch_step import jax_batch

    nb = dict(dp["inputs"]["batch"])
    jb = jax_batch({k: v for k, v in nb.items()
                    if k not in ("ray_idx", "t_rand")}
                   | {"weights": tuple(nb["weights"])})
    idx, t_rand = jnp.asarray(nb["ray_idx"][0]), jnp.asarray(nb["t_rand"][0])
    jb["ray_idx"], jb["t_rand"] = idx.astype(jnp.int32), t_rand
    s = JS.StepStatic(**{**static(stage).__dict__})
    mesh = make_mesh(WORLD)
    params = jax.tree_util.tree_map(jnp.asarray, dp["inputs"]["step_params"])
    rcfg = JRendererConfig(**STEP_RCFG)

    def loss(p):
        return JS.compute_losses(jcfgs(STEP_CFGS), rcfg, s, p, jb, idx,
                                 t_rand=t_rand, mesh=mesh)

    _, ref_g = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    # The step donates its state: it gets its own copy.
    _, ref_m = JS.build_train_step(jcfgs(STEP_CFGS), rcfg, s, mesh=mesh)(
        JS.init_train_state(jax.tree_util.tree_map(jnp.array, params)), jb,
        jax.random.PRNGKey(0))
    got = dp["ranks"][0]["steps"][stage]
    for k, r in ref_m.items():
        np.testing.assert_allclose(got["metrics"][0][k], np.asarray(r),
                                   rtol=2e-5, atol=1e-6, err_msg=k)
    ref_g = {k: ref_g[k] for k in stepped_nets(stage)}
    assert_close_share(got["grads"][0], ref_g, STAGES[stage][1], 1e-6, stage)


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_dp_step_matches_single_device_step(dp, stage):
    """(b) Each of the 3 steps' summed gradients and global metrics against
    the 1-rank step's on the global batch at the same weights, on both
    ranks."""
    for rank in range(WORLD):
        got = dp["ranks"][rank]["steps"][stage]
        ref = dp["ranks"][0]["steps"][stage]
        for k in range(STEPS):
            over = excess(got["grads"][k], ref["ref_grads"][k],
                          order_bounds(ref["ref_grads"][k],
                                       ref["reordered_grads"][k]))
            assert max(over.values()) <= 1.0, (rank, k, max(over.items(),
                                                            key=lambda x: x[1]))
            for key, r in ref["ref_metrics"][k].items():
                np.testing.assert_allclose(
                    got["metrics"][k][key], r, rtol=DP_METRIC_RTOL,
                    atol=1e-7, err_msg=f"rank {rank} step {k} {key}")


@pytest.mark.parametrize("stage", sorted(STAGES))
def test_replicas_stay_bitwise_equal(dp, stage):
    """(b) After 3 steps the two ranks hold the same parameters, bit for
    bit (the gradient bucket's sum is the same bytes on both)."""
    a = _flatten(dp["ranks"][0]["steps"][stage]["params"])
    b = _flatten(dp["ranks"][1]["steps"][stage]["params"])
    assert set(a) == set(b)
    for k, v in a.items():
        np.testing.assert_array_equal(v, b[k], err_msg=k)


def test_per_rank_mean_fault_fails_the_bound(dp):
    """(c) Local denominators (each rank's loss as one device would take it
    on its slice, the gradients averaged) miss the global gradients by
    more than (b)'s bound: the test of (b) would catch the fault."""
    rec = dp["ranks"][0]["steps"]["stage1"]
    bounds = order_bounds(rec["ref_grads"][0], rec["reordered_grads"][0])
    over = excess(dp["ranks"][0]["steps"]["fault_grads"], rec["ref_grads"][0],
                  bounds)
    assert max(over.values()) > 10, sorted(over.items(), key=lambda x: x[1])[-3:]


def test_split_render_matches_single_and_jax(dp):
    """(d) Each rank's gathered view against the 1-rank port render and the
    JAX renderer on a 2-device mesh (chunk 16: 4 chunks, 8 rays a rank)."""
    jax, JF, jcfgs = _jax()
    from copenerf_tpu.evaluation.render import ImageRenderer as JImageRenderer
    from copenerf_tpu.ops.renderer import RendererConfig as JRendererConfig
    from copenerf_tpu.parallel.mesh import make_mesh
    from test_torch_render_image import _compare

    ra = dp["inputs"]["render_args"]
    args = (*(ra[k] for k in RENDER_ARGS_KEYS), float(ra["t"]), RENDER_RES,
            (0.5, 4.0), 0.6)
    fields = X.params_from_jax(dp["inputs"]["render_params"], RENDER_CFGS,
                               "cpu")
    single = ImageRenderer(RendererConfig(**RENDER_RCFG), chunk=RENDER_CHUNK,
                           device="cpu").render_image(fields, *args,
                                                      want_pts=True)
    jr = JImageRenderer(jcfgs(RENDER_CFGS), JRendererConfig(**RENDER_RCFG),
                        chunk=RENDER_CHUNK, mesh=make_mesh(WORLD))
    ref = jr.render_image(dp["inputs"]["render_params"], *args, want_pts=True)
    for rank in range(WORLD):
        got = {k: v for k, v in dp["ranks"][rank]["render"].items()
               if k != "chunks"}
        assert list(dp["ranks"][rank]["render"]["chunks"]) == [jr.min_chunk,
                                                               jr.chunk]
        _compare(single, got)
        _compare(ref, got)
        for k in ("color", "depth", "weights_flat", "pts_flat"):
            np.testing.assert_array_equal(
                got[k], dp["ranks"][0]["render"][k], err_msg=k)


def test_two_rank_trainer_matches_one_rank(dp):
    """(e) The loss curve (10 iterations across the transition) and the
    refined poses of the 2-rank Trainer against the 1-rank one; the poses
    and the final weights equal on both ranks."""
    single, ranks = dp["single"], [r["trainer"] for r in dp["ranks"]]
    assert len(single["losses"]) == 10
    for t in ranks:
        np.testing.assert_allclose(t["losses"], single["losses"],
                                   rtol=LOSS_RTOL, atol=0)
        np.testing.assert_allclose(t["poses"], single["poses"], rtol=0,
                                   atol=POSE_ATOL)
        assert int(t["fell_back"]) == 0
    np.testing.assert_array_equal(ranks[0]["poses"], ranks[1]["poses"])
    a, b = _flatten(ranks[0]["params"]), _flatten(ranks[1]["params"])
    for k, v in a.items():
        np.testing.assert_array_equal(v, b[k], err_msg=k)


def test_rank1_writes_nothing(dp):
    """(e) Rank 0 wrote the run (logs, refined poses, visualizations); rank
    1, with its own out_dir, wrote no file."""
    work = dp["work"]
    out0 = os.path.join(work, "out0")
    assert os.path.isfile(os.path.join(out0, "models", "refine_pose.npz"))
    assert os.path.isfile(os.path.join(out0, "logs", "scalars.jsonl"))
    assert os.listdir(os.path.join(out0, "rendering"))
    out1 = os.path.join(work, "out1")
    files = [os.path.join(d, f) for d, _, fs in os.walk(out1) for f in fs]
    assert files == []


def test_two_rank_evaluator_matches_one_rank(dp, tmp_path):
    """(e) The 2-rank evaluation of rank 0's run: rank 0's metrics equal
    those of a 1-rank Evaluator on a copy of the run without the test-pose
    cache (the same poses are optimized, and the split render is the 1-rank
    render); rank 1 returns None; rank 0 wrote the cache and results."""
    import shutil

    with open(os.path.join(dp["work"], "trainer.json")) as f:
        cfg = json.load(f)
    out0 = os.path.join(dp["work"], "out0")
    cache = os.path.join("models", "weights", "model_eval_pose.npz")
    assert os.path.isfile(os.path.join(out0, cache))
    assert os.path.isfile(os.path.join(out0, "results.txt"))
    copy_dir = str(tmp_path / "run")
    shutil.copytree(out0, copy_dir)
    os.remove(os.path.join(copy_dir, cache))
    ref = run_evaluator(eval_cfg(cfg, copy_dir))
    got = dp["ranks"][0]["eval"]
    assert set(got) == set(ref)
    assert dp["ranks"][1]["eval"] == {"returned_none": 1}
    for k, v in ref.items():
        np.testing.assert_allclose(float(got[k]), v, rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    np.testing.assert_array_equal(
        load_pytree(os.path.join(copy_dir, cache))["r"],
        load_pytree(os.path.join(out0, cache))["r"])


def test_ranks_import_no_jax(dp):
    """The ranks' program loads no JAX module. (Rank 0's scalar logger
    attaches TensorBoard where it is installed, and TensorFlow's import
    loads JAX there; rank 1 logs nothing.)"""
    for r in dp["ranks"]:
        assert list(r["jax_modules_before_trainer"]) == []
    assert list(dp["ranks"][1]["jax_modules_at_end"]) == []


@pytest.mark.parametrize("guard,message", [
    ("replicas", "the ranks' parameters differ"),
    ("rays", "does not split into whole 4x4 patches over 2 ranks"),
    ("n_devices", "torchrun --nproc-per-node 1"),
    ("chunk", "render chunk 1 < mesh size 2"),
])
def test_guards_raise(dp, guard, message):
    """(f) Replicas that differ in one bias entry on rank 1 (raised on both
    ranks), 48 rays (3 patches) over 2 ranks, ``n_devices`` 1 under 2
    processes, a render chunk below the world size."""
    for r in dp["ranks"]:
        assert message in str(r["guards"][guard])


def test_nccl_with_more_ranks_than_cards_raises(monkeypatch):
    """(f) NCCL for 2 ranks on a host without cards refuses, naming the
    counts, before it joins anything."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match=r"2 rank\(s\) on this host .* "
                       f"{torch.cuda.device_count()} card"):
        dist.initialize("nccl")
    assert not torch.distributed.is_initialized()


def test_initialize_without_torchrun_is_a_no_op(monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    dist.initialize()
    assert not torch.distributed.is_initialized()
    assert (dist.rank(), dist.world_size(), dist.is_primary(),
            dist.process_group()) == (0, 1, True, None)


def test_kernel_device_guard_raises_on_another_card():
    """A kernel input on cuda:1 while cuda:0 is the current device raises
    (the C entry points would launch on the current one)."""
    with pytest.raises(ValueError, match="tensor on cuda:1, but the current "
                       "device is cuda:0"):
        KB.check_device(1, 0, "x")
    KB.check_device(0, 0, "x")


if __name__ == "__main__":
    if sys.argv[2] == "single":
        _single_main(sys.argv[1])
    else:
        _rank_main(sys.argv[1], int(sys.argv[2]))
