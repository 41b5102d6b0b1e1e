"""BENCHMARK.json against the benchmark's contract, and every piece it names
found by name."""

from __future__ import annotations

import os
import re

import pytest

from portbench import drivers
from portbench.run import ROOT, load_json, reader

BENCH = load_json("BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert os.path.isfile(os.path.join(ROOT, BENCH["command"][1]))


def test_names_and_units_use_the_allowed_characters():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w["config"] for w in BENCH["workloads"]]
             + [w["traffic"] for w in BENCH["workloads"]])
    for n in names:
        assert NAME.match(n), n
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert len(set(CELLS)) == len(CELLS)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("workload", CELLS)
def test_each_cells_files_are_found_by_name(workload):
    w = next(c for c in BENCH["workloads"] if c["name"] == workload)
    assert w["chips"] in (1, 4)
    cfg = load_json("portbench", "configs", f"{w['config']}.json")
    mix = load_json("portbench", "traffic", f"{w['traffic']}.json")
    limits = load_json("portbench", "limits", f"{workload}.json")
    assert cfg["name"] == w["config"]
    assert cfg["reduced"] == next(c["reduced"] for c in BENCH["configs"]
                                  if c["name"] == w["config"])
    driver = drivers.load(mix["kind"])
    for method in ("warm_up", "unit", "counts", "unit_flop", "release",
                   "reference", "compare"):
        assert callable(getattr(driver, method)), (mix["kind"], method)
    assert limits and all(v > 0 for v in limits.values())


def test_an_unknown_kind_has_no_driver():
    for kind in ("no_such_kind", "_common"):
        with pytest.raises(ValueError):
            drivers.load(kind)


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_each_metric_has_a_reader(metric):
    assert callable(reader(metric))


def test_configs_are_files_under_paths_and_used():
    used = {w["config"] for w in BENCH["workloads"]}
    files = set()
    for c in BENCH["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["source"].startswith("https://")
        assert c["name"] in used
        files.add(c["file"])
    assert len(files) == len(BENCH["configs"])


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_per_layer_metrics_move_an_end_to_end_metric_of_their_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"] if _reports(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert any(_reports(m, cell) for m in BENCH["per_layer"]), cell


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert "bound" not in m
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_run_seconds_fit_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_published_widths():
    from portbench.work import Shapes

    for c in BENCH["configs"]:
        cfg = load_json("portbench", "configs", f"{c['name']}.json")
        s = cfg["neus_sdf_network"]
        assert (s["d_in"], s["d_hidden"], s["n_layers"], s["d_out"],
                s["skip_in"], s["multires"]) == (4, 256, 8, 257, [4], 6)
        col = cfg["neus_rendering_network"]
        assert (col["mode"], col["d_hidden"], col["n_layers"]) == ("idr", 256, 4)
        m = cfg["motion_network"]
        assert (m["d_hidden"], m["n_layers"], m["skip_in"]) == (256, 4, [2])
        r = cfg["neus_renderer"]
        assert (r["n_samples"], r["n_importance"], r["up_sample_steps"],
                r["n_outside"]) == (64, 64, 4, 0)
        assert Shapes.of(cfg).sdf_first == 52 * 256
