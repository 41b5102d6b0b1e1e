"""The run's refusals: no card, a card it cannot name, JAX or the JAX
package loaded; and a card test that runs one short cell."""

from __future__ import annotations

import json
import subprocess
import sys
import types

import pytest

from portbench import run


def test_the_import_check_fires_on_a_planted_import(monkeypatch):
    assert run.forbidden_modules({"copenerf_torch": 1, "jaxtyping": 1,
                                  "copenerf_tpu_x": 1, "torch.jax": 1}) == []
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "copenerf_tpu.models",
                        types.ModuleType("copenerf_tpu.models"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.forbidden_modules() == ["copenerf_tpu.models", "jax"]


def test_a_run_imports_neither_jax_nor_the_jax_package():
    code = ("import glob, os; from portbench import drivers, run, control,"
            " trace; [drivers.load(os.path.basename(p)[:-3]) for p in"
            " glob.glob('portbench/drivers/[!_]*.py')];"
            " import copenerf_torch.evaluation.evaluator,"
            " copenerf_torch.training.step, copenerf_torch.evaluation.render;"
            " print(run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cell = run.load_json("BENCHMARK.json")["workloads"][0]["name"]
    rc = run.main(["--workload", cell, "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "no result" in out.err


def test_a_card_without_a_name_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def no_smi(*a, **k):
        raise FileNotFoundError("nvidia-smi")
    monkeypatch.setattr(run.subprocess, "run", no_smi)
    cell = run.load_json("BENCHMARK.json")["workloads"][0]["name"]
    rc = run.main(["--workload", cell, "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.get_device_name()


@pytest.mark.gpu
def test_one_cell_runs_on_the_card(card):
    cell = run.load_json("BENCHMARK.json")["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         "2147483901", "--seconds", "3", "--trace", "0"], cwd=run.ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert result["device"]["kind"] == card
