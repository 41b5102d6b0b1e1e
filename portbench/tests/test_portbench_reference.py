"""The comparison that decides ``correct``, at small sizes on the CPU: the
reference agrees with the program's plain path, its TF32 control fails the
cell's limits, and a run with a fault planted under the timed path comes
out not correct. (On the card the same control runs at the cells' own sizes
through ``portbench/control.py``.)"""

from __future__ import annotations

import math

import pytest

from portbench import faults
from portbench.control import readings
from portbench.run import load_json, run_cell
from portbench.tests import tiny

CELLS = [w["name"] for w in tiny.BENCH["workloads"]]
SEED = 2 ** 31 + 12345


def _passes(gaps: dict, limits: dict) -> bool:
    return all(math.isfinite(v) and v <= limits[k] for k, v in gaps.items())


@pytest.mark.parametrize("workload", CELLS)
def test_reference_agrees_with_the_plain_path_and_the_control_fails(workload):
    limits = load_json("portbench", "limits", f"{workload}.json")
    r = readings(tiny.BENCH, workload, SEED, 1, device="cpu",
                 **tiny.sizes(workload))
    assert all(v < 1e-4 for v in r["program"].values()), r
    assert _passes(r["program"], limits), r
    assert not _passes(r["control"], limits), r


def _cases():
    for w in CELLS:
        kind = load_json("portbench", "traffic",
                         f"{tiny.cell(w)['traffic']}.json")["kind"]
        for fault in faults.applicable(kind):
            yield w, fault, kind


@pytest.mark.parametrize("workload, fault, kind", list(_cases()))
def test_a_planted_fault_comes_out_not_correct(workload, fault, kind):
    with faults.planted(fault, kind):
        result = run_cell(tiny.BENCH, workload, SEED, 0.1, False,
                          device="cpu", **tiny.sizes(workload))
    assert result["correct"] is False, (fault, result["checks"])


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct_and_reports_its_metrics(workload, trace):
    result = run_cell(tiny.BENCH, workload, SEED, 0.1, trace, device="cpu",
                      **tiny.sizes(workload))
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    group = tiny.BENCH["per_layer" if trace else "end_to_end"]
    names = {m["name"] for m in group
             if workload in m.get("workloads", [workload])}
    if trace:
        # No device on the CPU: the kernels' rooflines find nothing to read.
        assert set(result["metrics"]) <= names and result["metrics"]
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert result["device"]["window_s"] > 0
    else:
        assert set(result["metrics"]) == names
    assert list(result)[-1] == "checks"
