"""Small sizes of the cells for CPU tests: the published configuration and
traffic files with every width, depth, sample count and frame cut down so
that a run takes seconds on the CPU (the program then takes its plain
PyTorch paths)."""

from __future__ import annotations

import copy

from portbench.run import load_json

BENCH = load_json("BENCHMARK.json")


def cell(name: str) -> dict:
    return next(w for w in BENCH["workloads"] if w["name"] == name)


def config(name: str) -> dict:
    cfg = copy.deepcopy(load_json("portbench", "configs", f"{name}.json"))
    cfg["training"]["resolution"] = [24, 32]
    cfg["assumed"]["n_frames"] = 12
    cfg["neus_sdf_network"].update(d_hidden=64, n_layers=4, skip_in=[2],
                                   d_out=33)
    cfg["neus_rendering_network"].update(d_hidden=32, n_layers=2,
                                         d_feature=32)
    cfg["motion_network"].update(d_hidden=16)
    cfg["neus_renderer"].update(n_samples=8, n_importance=8, up_sample_steps=2)
    cfg["neus_nerf"].update(W=16, D=2, skips=[])
    return cfg


def mix(name: str) -> dict:
    m = copy.deepcopy(load_json("portbench", "traffic", f"{name}.json"))
    if "rays" in m:
        m["rays"] = 64
    if m["kind"] == "render":
        m.update(chunk=256, warmup_resolution=[8, 16], check_rays_per_view=64)
    m["trace_units"] = 2
    return m


def sizes(workload: str) -> dict:
    """``cfg`` and ``mix`` keyword arguments of a small run of ``workload``."""
    c = cell(workload)
    return {"cfg": config(c["config"]), "mix": mix(c["traffic"])}
