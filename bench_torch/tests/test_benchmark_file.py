"""BENCHMARK.json names only what the harness finds by name, within the
limits of its format."""

import json
import re

import harness
import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_every_entry_is_found_by_name():
    b = harness.load_benchmark()
    assert b["command"] == ["python3", "bench_torch/run.py"] and b["paths"] == ["bench_torch"]
    assert 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        cfg = spec.load_config(c["name"])
        assert c["file"] == f"bench_torch/configs/{c['name']}.json" and c["reduced"] == cfg["reduced"]
        names.add(c["name"])
    used = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        wl = spec.load_workload(w["name"])
        assert wl["config"] == w["config"] and wl["why"] == w["why"] and len(w["why"]) <= 200
        assert (harness.ROOT / "drivers" / f"{wl['driver']}.py").exists()
        used.add(w["config"])
    assert used == names
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in b["per_layer"]:
        assert (harness.ROOT / "metrics" / f"{m['name']}.py").exists()
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert cell in next(e["workloads"] for e in b["end_to_end"]
                                if e["name"] == m["moves"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for cell in cells:
        assert len(harness.metrics_for(b, cell, False)) >= 2
        assert len(harness.metrics_for(b, cell, True)) >= 1
    assert len(json.dumps(b)) < 64 * 1024


def test_measured_command_refuses_without_a_card():
    import subprocess
    import sys

    import pytest
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    p = subprocess.run([sys.executable, str(harness.ROOT / "run.py"), "--workload",
                        "apertus-8b.chat-img", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, cwd=harness.REPO, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_jax_modules_are_named_by_their_whole_top_level_name(monkeypatch):
    import sys
    import types

    for name in list(sys.modules):
        if name.split(".")[0] in harness.JAX_NAMES:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "multimeditron_torch_x", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert harness.jax_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "multimeditron_tpu.models", types.ModuleType("x"))
    assert harness.jax_modules() == ["jax", "multimeditron_tpu"]
