"""Each driver kind at a tiny size on the CPU, through ``rehearse`` (not
the measured command), with the timed path sound and then broken: every
fault the cell can have must turn ``correct`` false at the cell's limits."""

import math
import time

import pytest
import torch

import faults
import harness
import rehearse
import spec

CELLS = {
    "apertus-8b.chat-img": None,
    "qwen3-4b.align-train": None,
    "apertus-8b.grpo-rollout": None,
    "qwen3-4b.chat-longtext": {"traffic": {"text_tokens": {"median": 40, "min": 20,
                                                           "max": 70}}},
}
SEED = 3_000_000_017  # over 32 bits, as benchmark seeds may be


@pytest.mark.parametrize("cell", list(CELLS))
def test_sound_run_is_correct(cell):
    out, run = rehearse.rehearse(cell, SEED, seconds=1.0, overrides=CELLS[cell])
    assert out["correct"], (out, run.notes)
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in harness.metrics_for(harness.load_benchmark(), cell, False)}
    assert set(out["metrics"]) == names
    assert all(math.isfinite(m["value"]) and m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", list(CELLS))
def test_traced_run_reads_only_what_it_finds(cell):
    """On the CPU the trace holds no device kernel: the kernel rooflines
    return nothing; the host-clock metrics read their spans."""
    out, run = rehearse.rehearse(cell, SEED + 1, seconds=1.5, trace=True,
                                 overrides=CELLS[cell])
    assert out["correct"], (out, run.notes)
    for name, m in out["metrics"].items():
        assert "roofline" not in name and m["value"] >= 0
        if m["unit"] == "%":
            assert m["value"] <= 100
    assert run.stretch is not None and run.stretch.summary is not None
    assert "breakdown" in out and out["device"]["window_s"] > 0


@pytest.mark.parametrize("cell", ["apertus-8b.chat-img", "apertus-8b.grpo-rollout",
                                  "qwen3-4b.chat-longtext"])
def test_altered_token_is_not_correct(cell):
    with faults.altered_token():
        out, run = rehearse.rehearse(cell, SEED + 2, seconds=1.0, overrides=CELLS[cell])
    assert not out["correct"], (out, run.notes)


def test_unchanged_state_is_not_correct():
    with faults.unchanged_state():
        out, run = rehearse.rehearse("qwen3-4b.align-train", SEED + 3, seconds=1.0)
    assert not out["correct"], (out, run.notes)
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_half_batch_is_not_correct():
    with faults.half_batch():
        out, run = rehearse.rehearse("qwen3-4b.align-train", SEED + 4, seconds=1.0)
    assert not out["correct"], (out, run.notes)


@pytest.mark.parametrize("cell", ["apertus-8b.chat-img", "qwen3-4b.align-train"])
def test_control_reads_above_the_program(cell):
    """The fp8 control on the tiny model: each seed's control reading lies
    above the program's on at least one number."""
    wl, cfg = rehearse.tiny(cell)
    for seed in (SEED + 10, SEED + 11, SEED + 12):
        run = harness.Run(workload=wl, cfg=cfg, d=spec.dims(cfg), seed=seed, seconds=1.0,
                          trace=False, device=torch.device("cpu"), t_process=time.time(),
                          control=True)
        harness.driver(wl["driver"]).run(run)
        ctl = run.notes["control"]
        prog = {c.name: c.value for c in run.checks}
        if "fp8" in ctl:
            assert ctl["fp8"] > ctl["program"] == prog["served_gap"]
        else:
            assert any(ctl[k] > prog[k] for k in prog)
