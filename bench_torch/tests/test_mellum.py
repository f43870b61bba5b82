"""The ``mellum`` architecture and its cell, ``mellum2-12b.grpo-long``, at a
tiny size on the CPU (``rehearse``; never a measurement): a sound run is
correct and a token altered where it is produced is not; the configuration's
counts are the hand-worked ones; the cell's kernel readers find nothing to
read in a CPU trace, and its host-span readers do."""

import pytest
import torch

import faults
import harness
import rehearse
import roofline
import spec
import weights

CELL = "mellum2-12b.grpo-long"
CONFIG = "mellum2-12b-a2.5b-clip-l14"
SEED = 3_000_000_029  # over 32 bits, as benchmark seeds may be
NEW = ("moe_roofline.long", "k4_roofline.long", "decode_mfu.long")
# the tiny expert model's own limits, set from its CPU readings (rehearse.py's
# 0.1 is the dense tiny model's): over 13 sound seeds served_gap 0-0.613 and
# served_gap_mean 0-0.052 (a few requests of 6 tokens: one near-tie of a
# top-2 router choice that bf16 swaps moves a whole reading; at 0.149 layer
# 2's second and third router scores lay 0.0009 apart); a token altered where
# it is produced 5.28-5.41 and 3.21-3.26 (2 seeds). The fp8 control does not
# separate at this size (0.038-1.88 and 0.009-0.29); the cell's own limits do
TINY_LIMIT = {"check": {"limit": 1.0, "mean_limit": 0.2}}


def tiny(overrides: dict = TINY_LIMIT):
    """The cell at rehearse.py's tiny sizes: its driver runs serve_backlog's
    traffic, so it takes serve_backlog's tiny traffic."""
    wl = rehearse.merge(spec.load_workload(CELL), rehearse.TINY_TRAFFIC["serve_backlog"])
    wl = rehearse.merge(wl, overrides)
    cfg = spec.load_config(wl["config"])
    cfg = spec.shrink(cfg, **spec.architecture(cfg["arch"]).TINY, **rehearse.TINY_TOWER)
    return wl, cfg


def rehearse_cell(seed: int, seconds: float = 1.0, trace: bool = False, **over):
    wl, cfg = tiny(rehearse.merge(TINY_LIMIT, over))
    return rehearse.run_tiny(CELL, wl, cfg, seed, seconds, trace)


def test_counts_are_the_hand_worked_ones():
    cfg = spec.load_config(CONFIG)
    d = spec.dims(cfg)
    assert d.kinds() == [(0, 21), (3, 7)]
    assert d.params(0) == d.params(3) == 417_747_456
    assert d.E * d.expert_params == 396_361_728
    assert d.decoder_params == 12_149_915_904 == cfg["params"]["decoder"]
    assert d.active_params(0) == 70_930_944
    assert d.body_params + d.V * d.D == pytest.approx(2.21e9, rel=0.01)
    # every expert read: the bf16 bytes of a decode step's weights
    assert d.decode_weight_bytes() == 2 * (12_149_915_904 - 226_492_416)
    assert d.decode_weight_bytes({"experts_touched": 0}) == \
        2 * (28 * (417_747_456 - 396_361_728) + 2304 + 226_492_416)
    # the published config at the top level of the file, as the catalog has it
    assert all(cfg[k] == v for k, v in cfg["decoder"].items())


def test_window_pairs_and_keys():
    d = spec.dims(spec.load_config(CONFIG))
    assert d.pairs(0, 1024) == d.pairs(3, 1024) == roofline.causal_pairs(1024)
    assert d.pairs(0, 3000) == roofline.causal_pairs(1024) + (3000 - 1024) * 1024
    assert d.pairs(3, 3000) == roofline.causal_pairs(3000)
    # a step over slots of 3,000 keys: the sliding layers attend 1,024 of them
    keys, read = roofline.step_keys(d, 0, [3000, 500])
    assert keys == read == 1024 + 500
    # a fork's shared prompt pages outside the window are not read at all
    assert roofline.step_keys(d, 0, [3000, 3000], [(1, 1280, 3000)])[1] == 2048
    assert roofline.step_keys(d, 3, [3000, 3000], [(1, 1280, 3000)])[1] == 6000 - 1280


def test_expert_counts():
    d = spec.dims(spec.load_config(CONFIG))
    assert d.moe_flops(1024) == 6.0 * 2304 * 896 * 1024
    assert d.moe_bytes(64, 1024) == 2 * (64 * 3 * 2304 * 896 + 2 * 2304 * 128)


def test_weight_blocks_keep_each_layers_experts_apart():
    cfg = tiny()[1]
    d = spec.dims(cfg)
    tags = [tag for tag, _ in d.layer_blocks(2)]
    assert tags == ["decoder.layer.2", "decoder.experts.2"]
    W = weights.decoder_layer(SEED, d, 2, "cpu")
    assert W["gate"].shape == (8, 32, 64) and W["down"].shape == (8, 64, 32)
    assert W["router"].shape == (8, 64) and W["q"].dtype == torch.bfloat16


def test_sound_run_is_correct():
    out, run = rehearse_cell(SEED)
    assert out["correct"], (out, run.notes)
    assert out["attempted"] > 0 and out["failed"] == 0
    names = {m["name"] for m in harness.metrics_for(harness.load_benchmark(), CELL, False)}
    assert set(out["metrics"]) == names == {"output_tok_s", "setup_s"}


def test_altered_token_is_not_correct():
    with faults.altered_token():
        out, run = rehearse_cell(SEED + 1)
    assert not out["correct"], (out, run.notes)


def test_new_readers_read_nothing_on_a_cpu_trace():
    out, run = rehearse_cell(SEED + 2, seconds=1.5, trace=True, trace_s=0.5)
    assert out["correct"], (out, run.notes)
    for name in NEW:
        assert harness.metric_reader(name)(run) is None, name
    assert not set(NEW) & set(out["metrics"])
    # the program's spans read on the CPU too; device idle needs device records
    assert out["metrics"]["decode_host_ms.long"]["value"] > 0, out
    for name in ("device_idle.long", "decode_idle_ms.long"):
        assert harness.metric_reader(name)(run) is None, name
