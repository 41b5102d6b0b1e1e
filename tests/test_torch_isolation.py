"""The port stands alone: nothing in ``copenerf_torch``, ``chip_smoke.py``,
``kernel_times.py`` or ``e2e_port.py`` imports JAX or the JAX package, and
importing the port loads neither."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "copenerf_tpu", "optax")


def _port_files():
    out = [os.path.join(REPO, f)
           for f in ("chip_smoke.py", "kernel_times.py", "e2e_port.py")]
    for root, _, files in os.walk(os.path.join(REPO, "copenerf_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys; import copenerf_torch, copenerf_torch.models, "
            "copenerf_torch.ops.renderer, copenerf_torch.evaluation.render, "
            "copenerf_torch.ops.kernels.sdf_value, "
            "copenerf_torch.ops.kernels.rendercore, "
            "copenerf_torch.ops.kernels.sdf_value_diff, "
            "copenerf_torch.ops.kernels.outgrad, "
            "copenerf_torch.ops.kernels.color, "
            "copenerf_torch.ops.kernels.rendercore_cons, "
            "copenerf_torch.ops.kernels.sdf_out, "
            "copenerf_torch.ops.kernels.emulate, "
            "copenerf_torch.poses.motion, copenerf_torch.poses.retriever, "
            "copenerf_torch.training.checkpoints, "
            "copenerf_torch.training.step, "
            "copenerf_torch.data, copenerf_torch.data.colmap, "
            "copenerf_torch.data.fields, copenerf_torch.data.dataloading, "
            "copenerf_torch.data.synthetic, "
            "copenerf_torch.evaluation.metrics_pose, "
            "copenerf_torch.models.torch_io, "
            "copenerf_torch.training.schedules, "
            "copenerf_torch.training.logging_utils, "
            "copenerf_torch.training.depth_metrics, "
            "copenerf_torch.training.trainer, "
            "copenerf_torch.training.pose_refinement, "
            "copenerf_torch.evaluation.evaluator, "
            "copenerf_torch.evaluation.metrics_image, "
            "copenerf_torch.evaluation.lpips_torch, "
            "copenerf_torch.evaluation.lpips_export, "
            "copenerf_torch.utils.profiling, "
            "copenerf_torch.utils.backup, copenerf_torch.utils.checks, "
            "copenerf_torch.utils.frustum, copenerf_torch.ops.trajectories, "
            "copenerf_torch.mesher.marching_cubes, copenerf_torch.cli, "
            "copenerf_torch.bench, copenerf_torch.parallel, "
            "copenerf_torch.parallel.distributed, "
            "copenerf_torch.parallel.mesh; "
            "copenerf_torch.evaluation.Evaluator; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
