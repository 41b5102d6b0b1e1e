"""The port's whole-pipeline head-to-head (``e2e_port.py``) against
``scripts/e2e_headtohead.py``, the JAX package's, on the CPU.

* The port's copies of the head-to-head's constants (schedule, nets, scene
  size, metric order), its config file and its seeded LPIPS arrays equal
  the JAX script's (loaded by path with ``importlib``; exact).
* A micro run of the port's pipeline (``e2e_port.MICRO``: 4 frames at
  18x24, 2 epochs across the transition, 2 refinement epochs, 1 eval-pose
  epoch) gives all 13 metrics finite, and the initial weights it writes
  (``ref_init.npz``) load with the JAX package's ``load_pytree`` into a tree
  with the JAX package's keys, shapes and dtypes.
* ``--compare`` passes equal inputs and fails a gap of twice the seed
  range; it refuses a mismatched init hash, a missing metric, a NaN and a
  JAX run that started before ``ref_init.npz`` was written.
* The committed ``PARITY_E2E_PORT.json`` holds the gate's rows as the
  gate computes them from its per-seed numbers, and the smoke's per-seed
  pose bounds hold its card run of seed 0.

The ``slow`` case runs seed 0 of the head-to-head on both sides and holds
the depth metrics to the gate's depth bound and the pose metrics to the
per-seed bound.
"""

import importlib.util
import json
import math
import os
import shutil

import jax
import numpy as np
import pytest

import e2e_port as E
from copenerf_tpu.config.loader import load_config as j_load_config
from copenerf_tpu.models import fields as JF
from copenerf_tpu.training.checkpoints import load_pytree as j_load_pytree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPORT = os.path.join(REPO, "PARITY_E2E_PORT.json")


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "e2e_headtohead_script",
        os.path.join(REPO, "scripts", "e2e_headtohead.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


H2H = _jax_script()


@pytest.mark.parametrize("name", ["SCHEDULE", "TINY", "N_FRAMES", "RES_H",
                                  "RES_W", "METRIC_ORDER"])
def test_constants_equal_the_jax_scripts(name):
    assert getattr(E, name) == getattr(H2H, name)


def test_seeded_lpips_arrays_equal_the_jax_scripts():
    for ours, theirs in zip(E.seeded_lpips_weights(),
                            H2H.seeded_lpips_weights()):
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            assert ours[k].dtype == theirs[k].dtype
            np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_config_file_equals_the_jax_scripts(tmp_path):
    import yaml

    out = str(tmp_path / "out")
    a = E.write_cfg(str(tmp_path), "/scene", "scene0", out, seed=3)
    with open(a) as f:
        ours = yaml.safe_load(f)
    b = H2H.write_cfg(str(tmp_path), "/scene", "scene0", out, seed=3)
    with open(b) as f:
        theirs = yaml.safe_load(f)
    assert ours == theirs


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("micro"))
    return root, E.run_torch(root, 0, "cpu", verbose=False, **E.MICRO)


def test_micro_run_gives_every_metric_finite(micro):
    root, res = micro
    assert all(math.isfinite(res[k]) for k in E.METRIC_ORDER), res
    assert res["_iters"] == 2 * res["train_views"] and res["test_views"] == 1
    with open(os.path.join(root, "port_cpu.json")) as f:
        assert json.load(f)["init_sha256"] == res["init_sha256"]
    assert E.sha256(os.path.join(root, "ref_init.npz")) == res["init_sha256"]


def test_micro_init_loads_in_the_jax_layout(micro):
    root, _ = micro
    tree = j_load_pytree(os.path.join(root, "ref_init.npz"))
    cfg = j_load_config(os.path.join(root, "cfg_port_cpu_out.yaml"))
    want = jax.eval_shape(lambda: JF.init_all_fields(
        jax.random.PRNGKey(0), JF.configs_from_cfg(cfg)))
    got_paths = jax.tree_util.tree_flatten_with_path(tree)[0]
    want_paths = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in got_paths] == [p for p, _ in want_paths]
    for (path, g), (_, w) in zip(got_paths, want_paths):
        assert g.shape == w.shape and g.dtype == w.dtype, path


def test_write_init_keeps_an_equal_file(micro):
    """An equal init is left as it is (the JAX run's start is held against
    its time); other weights raise and leave the file as it was."""
    from copenerf_torch.training.checkpoints import load_pytree

    root, res = micro
    path = os.path.join(root, "ref_init.npz")
    tree = load_pytree(path)
    before = os.stat(path).st_mtime_ns
    os.utime(path, ns=(before - 10 ** 9, before - 10 ** 9))
    assert E.write_init(path, tree) == res["init_sha256"]
    assert os.stat(path).st_mtime_ns == before - 10 ** 9
    leaf = tree
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    leaf += 1.0
    with pytest.raises(RuntimeError, match="other initial weights"):
        E.write_init(path, tree)
    assert E.sha256(path) == res["init_sha256"]
    assert os.listdir(root).count("ref_init.npz.new.npz") == 0


def test_port_refuses_to_overwrite_another_init(micro, tmp_path):
    root, _ = micro
    other = tmp_path / "other"
    other.mkdir()
    shutil.copy(os.path.join(root, "ref_init.npz"), other / "ref_init.npz")
    with pytest.raises(RuntimeError, match="other initial weights"):
        E.run_torch(str(other), 1, "cpu", verbose=False, **E.MICRO)


def _fake_roots(tmp_path, shift=None, plant=None):
    """Three seed roots whose three sides hold the same per-seed numbers
    (seed s: metric value v0 * (1 + 0.1 s)); ``shift`` moves the card
    column's metric by a multiple of its range, ``plant`` spoils one side."""
    rng = np.random.default_rng(0)
    base = {k: float(rng.uniform(0.5, 2.0)) for k in E.METRIC_ORDER}
    roots = []
    for seed in E.SEEDS:
        root = tmp_path / f"seed{seed}"
        root.mkdir()
        init = root / "ref_init.npz"
        np.savez(init, a=np.full(3, seed, np.float32))
        digest = E.sha256(str(init))
        (root / "cfg_our_out.yaml").write_text("training: {}\n")
        vals = {k: v * (1 + 0.1 * seed) for k, v in base.items()}
        walls = {"_iters": 560, "_train_wall_s": 1.0, "_eval_wall_s": 1.0}
        with open(root / "results.json", "w") as f:
            json.dump({"ours": {**vals, **walls}}, f)
        for side in ("cpu", "cuda"):
            res = {**vals, **walls, "init_sha256": digest, "seed": seed,
                   "card": "card, 700 W" if side == "cuda" else None}
            if side == "cuda" and shift is not None:
                k, times = shift
                res[k] += times * 0.2 * base[k]   # the range is 0.2 v0
            if side == "cuda" and plant is not None and seed == 1:
                key, value = plant
                if value is None:
                    del res[key]
                else:
                    res[key] = value
            with open(root / f"port_{side}.json", "w") as f:
                json.dump(res, f)
        roots.append(str(root))
    return roots


@pytest.mark.parametrize("case", ["equal", "gap_quality", "gap_depth"])
def test_compare_gate(tmp_path, case):
    shift = {"equal": None, "gap_quality": ("PSNR", 2.0),
             "gap_depth": ("abs_rel", 2.0)}[case]
    roots = _fake_roots(tmp_path, shift=shift)
    out = str(tmp_path / "report.json")
    ok = E.compare(roots, out, str(tmp_path / "report.md"))
    with open(out) as f:
        report = json.load(f)
    assert ok == (case == "equal") == report["ok"]
    failed = {(c, k) for c, rows in report["rows"].items()
              for k, r in rows.items() if not r["ok"]}
    assert failed == (set() if shift is None else {("port_cuda", shift[0])})
    assert E.main(["--compare", *roots, "--out", out]) == (0 if ok else 1)


@pytest.mark.parametrize("plant", [("init_sha256", "0" * 64),
                                   ("ate", None), ("SSIM", float("nan")),
                                   "jax_before_init"],
                         ids=["init_hash", "missing_metric", "nan",
                              "jax_before_init"])
def test_compare_refuses(tmp_path, plant):
    if plant == "jax_before_init":
        # seed 1's JAX run started before its ref_init.npz was written
        roots = _fake_roots(tmp_path)
        t = os.stat(os.path.join(roots[1], "ref_init.npz")).st_mtime - 60
        os.utime(os.path.join(roots[1], "cfg_our_out.yaml"), (t, t))
    else:
        roots = _fake_roots(tmp_path, plant=plant)
    out = str(tmp_path / "report.json")
    with pytest.raises(ValueError):
        E.compare(roots, out)
    assert not os.path.exists(out)


def test_committed_report_holds_its_gate():
    """The committed report's rows are the gate over its per-seed numbers,
    and the smoke's bounds hold the card's seed-0 run."""
    with open(REPORT) as f:
        report = json.load(f)
    assert report["seeds"] == list(E.SEEDS)
    for column in ("port_cpu", "port_cuda"):
        assert E.gate_rows(report["per_seed"], column) == report["rows"][column]
    assert report["ok"] == all(r["ok"] for rows in report["rows"].values()
                               for r in rows.values())
    bounds = E.smoke_bounds(report, 0)
    for k, (lo, hi) in bounds.items():
        assert lo <= report["per_seed"]["port_cuda"][k][0] <= hi, k


@pytest.mark.parametrize("metric", E.POSE)
def test_smoke_pose_bound_is_the_seed_gap(metric):
    """For a pose metric the smoke's interval is JAX seed 0 +- the per-seed
    bound (tighter than the seed band), and it holds the committed card
    run of seed 0 but not one moved by twice the bound."""
    with open(REPORT) as f:
        report = json.load(f)
    ps = report["per_seed"]
    lo, hi = E.smoke_bounds(report, 0)[metric]
    g = E.seed_gap_bound(ps, metric)
    jax0 = ps["jax"][metric][0]
    assert g > 0 and (lo, hi) == (jax0 - g, jax0 + g)
    assert hi - lo < 2 * E.metric_bound(metric, ps, None, None)
    card = ps["port_cuda"][metric][0]
    assert lo <= card <= hi and not lo <= card + 2 * g <= hi


@pytest.mark.slow
def test_seed0_head_to_head_depth_bound(tmp_path, monkeypatch):
    """Seed 0 of the head-to-head on both sides from one init: each depth
    metric within the gate's depth bound (``metric_bound`` of the port CPU
    column, around JAX's value), each pose metric within the per-seed bound
    (``seed_gap_bound``) of the committed report."""
    with open(REPORT) as f:
        report = json.load(f)
    root = str(tmp_path)
    # run_ours names its LPIPS pack in the environment: restored after.
    for k in ("COPENERF_LPIPS_VGG", "COPENERF_LPIPS_LIN"):
        monkeypatch.setenv(k, "")
    port = E.run_torch(root, 0, "cpu", verbose=False)
    base, name = os.path.join(root, "co3d_synth"), "scene0"
    feats, heads = H2H.seeded_lpips_weights()
    ours = H2H.run_ours(root, base, name, feats, heads, seed=1000)
    ps = report["per_seed"]
    for k in E.DEPTH + E.POSE:
        bound = (E.metric_bound(k, ps, "port_cpu", ours[k]) if k in E.DEPTH
                 else E.seed_gap_bound(ps, k))
        assert abs(port[k] - ours[k]) <= bound, (k, port[k], ours[k], bound)
