"""The port's tracer (``multimeditron_torch.profiling.tracer``): off it
records nothing; on it nests spans in a bounded ring on the clock that
``torch.profiler`` maps its events onto; the serving engine and the trainer
record their phases with it, without changing a token or a loss; the
profiler window exports the spans; the throughput meter counts real tokens."""

import json
import time

import numpy as np
import pytest
import torch

from multimeditron_torch import profiling
from multimeditron_torch.modalities.image_clip import ImageConfig
from multimeditron_torch.models.llama import LlamaConfig
from multimeditron_torch.models.multimodal import (MultimodalConfig, MultimodalModel,
                                                   TrainingMode, mm_item_count)
from multimeditron_torch.profiling import Tracer, tracer
from multimeditron_torch.serve.engine import EngineConfig, ServingEngine
from multimeditron_torch.train import trainer as tt

N_EMB = 4  # a 28-pixel image in patches of 14


def _model() -> MultimodalModel:
    llm = LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_layers=2,
                      num_heads=2, num_kv_heads=1, dtype=torch.float32)
    img = ImageConfig(model_type="meditron_clip", hidden_size=32, image_size=28, patch_size=14,
                      vision_hidden_size=16, vision_layers=1, vision_heads=2,
                      vision_intermediate_size=32, param_dtype="float32", wire_dtype="uint8")
    model = MultimodalModel(MultimodalConfig(llm=llm, modalities=[img], eos_token_idx=1),
                            device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    return model


def _prompt(r: np.random.Generator, n: int) -> dict:
    ids = r.integers(2, 64, (1, n)).astype(np.int32)
    return {"input_ids": ids, "attention_mask": np.ones_like(ids),
            "mm_inputs": {"image": {
                "values": r.integers(0, 256, (1, 28, 28, 3), dtype=np.uint8),
                "batch_idx": np.zeros((N_EMB,), np.int32),
                "token_pos": np.arange(1, 1 + N_EMB, dtype=np.int32)}}}


def _train_batch(r: np.random.Generator, lens=(20, 13), S=32, slots=3) -> dict:
    B = len(lens)
    mask = (np.arange(S)[None, :] < np.asarray(lens)[:, None]).astype(np.int32)
    ids = np.where(mask == 1, r.integers(2, 64, (B, S)), 0).astype(np.int32)
    labels = np.where(mask == 1, ids, -100).astype(np.int32)
    labels[:, :1 + N_EMB] = -100
    values = np.zeros((slots, 28, 28, 3), np.uint8)
    values[:B] = r.integers(0, 256, (B, 28, 28, 3), dtype=np.uint8)
    batch_idx = np.full((slots * N_EMB,), B, np.int32)
    batch_idx[:B * N_EMB] = np.repeat(np.arange(B, dtype=np.int32), N_EMB)
    token_pos = np.zeros((slots * N_EMB,), np.int32)
    token_pos[:B * N_EMB] = np.tile(np.arange(1, 1 + N_EMB, dtype=np.int32), B)
    return {"input_ids": ids, "attention_mask": mask, "labels": labels,
            "mm_inputs": {"image": {"values": values, "batch_idx": batch_idx,
                                    "token_pos": token_pos}}}


@pytest.fixture
def traced():
    """The port's tracer, on and cleared; off again afterwards."""
    tracer.enable()
    try:
        yield tracer
    finally:
        tracer.disable()


def _by_index(spans):
    return {s["index"]: s for s in spans}


def _ancestors(s, by_index):
    names = []
    while s["parent"] is not None:
        s = by_index[s["parent"]]
        names.append(s["name"])
    return names


# ----------------------------------------------------------------------
# The tracer alone
# ----------------------------------------------------------------------
def test_off_records_nothing():
    tr = Tracer()
    with tr.span("a", n=1) as sp:
        assert not sp
        sp.set(m=2)
    assert tr.span("b") is tr.span("c")  # one shared no-op
    assert tr.spans() == []
    tr.enable()
    tr.disable()
    with tr.span("d"):
        pass
    assert tr.spans() == []


def test_on_nests_spans_with_their_parents():
    tr = Tracer()
    tr.enable()
    with tr.span("outer", k=1) as a:
        assert a
        with tr.span("mid"):
            with tr.span("inner") as c:
                c.set(ran=True)
        with tr.span("second"):
            pass
        a.set(done=3)
    with tr.span("after"):
        pass
    spans = tr.spans()
    assert [(s["name"], s["parent"]) for s in spans] == [
        ("outer", None), ("mid", 0), ("inner", 1), ("second", 0), ("after", None)]
    assert spans[0]["attrs"] == {"k": 1, "done": 3} and spans[2]["attrs"] == {"ran": True}
    for s in spans:
        assert s["t0_ns"] <= s["t1_ns"]
        if s["parent"] is not None:
            p = spans[s["parent"]]
            assert p["t0_ns"] <= s["t0_ns"] and s["t1_ns"] <= p["t1_ns"]
    # enable() clears
    tr.enable()
    assert tr.spans() == []


def test_ring_keeps_the_newest_spans(monkeypatch):
    monkeypatch.setattr(profiling, "_RING", 8)
    tr = Tracer()
    tr.enable()
    for i in range(20):
        with tr.span("s", i=i):
            pass
    spans = tr.spans()
    assert [s["attrs"]["i"] for s in spans] == list(range(12, 20))
    assert [s["index"] for s in spans] == list(range(12, 20))


def test_profiler_events_fall_on_the_spans_clock():
    """An operation's profiler event, mapped through ``trace_start_ns``,
    lies inside the span taken around it with ``time.time_ns()``."""
    tr = Tracer()
    tr.enable()
    a = torch.randn(256, 256)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        time.sleep(0.002)
        with tr.span("mm"):
            a @ a
        time.sleep(0.002)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    (mm,) = [e for e in prof.events() if e.name == "aten::mm"]
    (span,) = tr.spans()
    assert span["t0_ns"] <= t0 + mm.time_range.start * 1e3
    assert t0 + mm.time_range.end * 1e3 <= span["t1_ns"]


# ----------------------------------------------------------------------
# The engine and the trainer
# ----------------------------------------------------------------------
ENGINE = dict(max_slots=4, max_seq_len=96, prefill_buckets=(16, 32), page_size=16,
              decode_chunk=4, do_sample=False)


def _serve(model, case: str):
    """Requests of one admission path: (engine, requests, their tokens)."""
    r = np.random.default_rng(1)
    eng = ServingEngine(model, EngineConfig(**ENGINE))
    if case == "grouped":
        reqs = [eng.submit(_prompt(r, n), max_new_tokens=6) for n in (10, 20, 12, 14, 9)]
    elif case == "forked":
        reqs = eng.submit_group(_prompt(r, 18), 2, max_new_tokens=5)
        reqs += [eng.submit(_prompt(r, 11), max_new_tokens=5)]
    else:  # chunked: past the largest bucket
        reqs = [eng.submit(_prompt(r, 40), max_new_tokens=4),
                eng.submit(_prompt(r, 12), max_new_tokens=4)]
    eng.run()
    return eng, reqs, [list(q.tokens) for q in reqs]


@pytest.mark.parametrize("case", ["grouped", "forked", "chunked"])
def test_engine_spans_nest_and_carry_request_ids(traced, case):
    eng, reqs, _ = _serve(_model(), case)
    spans = traced.spans()
    by_index = _by_index(spans)
    names = {s["name"] for s in spans}
    assert {"engine.step", "engine.admit", "engine.prefill", "prefill.embed", "tower.encode",
            "prefill.decoder", "prefill.sample", "decode.chunk", "decode.step",
            "decode.wait", "decode.forward", "decode.sample", "decode.fold",
            "engine.replay"} <= names
    steps = [s for s in spans if s["name"] == "decode.step"]
    assert steps and all(_ancestors(s, by_index)[:2] == ["decode.chunk", "engine.step"]
                         for s in steps)
    assert sum(s["attrs"]["ran"] for s in steps) == eng.n_decode_steps
    assert all(s["parent"] is None for s in spans if s["name"] == "engine.step")
    # each prefilled request's id is in exactly one engine.prefill, a prompt
    # past the largest bucket in one a chunk, with the chunk's own tokens
    prefills = [s for s in spans if s["name"] == "engine.prefill"]
    assert len(prefills) == eng.n_prefill_calls
    tokens = {}
    for s in prefills:
        a = s["attrs"]
        assert len(a["rids"]) == len(a["tokens"]) == len(a["images"])
        assert a["images"] == [1] * len(a["rids"])
        assert all(0 < n <= ENGINE["prefill_buckets"][-1] for n in a["tokens"])
        for rid, n in zip(a["rids"], a["tokens"]):
            tokens.setdefault(rid, []).append(n)
    forks = {f.request_id for q in reqs for f in q.forks}
    prompts = {q.request_id: int(q.batch["attention_mask"].sum()) for q in reqs
               if q.request_id not in forks}
    assert tokens == {rid: [n] if n <= 32 else [32, n - 32] for rid, n in prompts.items()}
    # the replay's emitted tokens are every token a decode step produced
    emitted = sum(n for s in spans if s["name"] == "engine.replay"
                  for n in s["attrs"]["emitted"].values())
    assert emitted == sum(len(q.tokens) - 1 for q in reqs)
    assert len([s for s in spans if s["name"] == "engine.fork"]) == (case == "forked")
    if case == "chunked":
        assert sorted(len(v) for v in tokens.values()) == [1, 2]


@pytest.mark.parametrize("rows, expected", [(2, 2), (1, 1), (0, 0)])
def test_mm_item_count_skips_unused_slots(rows, expected):
    """A collated pack of three item slots, two in use (rows 0 and 1): a
    slot counts only where its batch row is below ``rows``."""
    pack = _train_batch(np.random.default_rng(6))["mm_inputs"]
    assert mm_item_count(pack, rows) == expected
    assert mm_item_count(None, rows) == 0


def test_trainer_records_its_phases(traced, tmp_path):
    model = _model()
    trainer = tt.MultimodalTrainer(model, tt.TrainerConfig(
        training_mode=TrainingMode.ALIGNMENT, output_dir=str(tmp_path)))
    r = np.random.default_rng(2)
    batches = [_train_batch(r), _train_batch(r)]
    trainer.train(iter(batches), num_steps=2)
    spans = traced.spans()
    by_index = _by_index(spans)
    steps = [s for s in spans if s["name"] == "train.step"]
    assert [s["attrs"] for s in steps] == [
        {"step": i, "tokens": 33, "padded": 64, "images": 2} for i in range(2)]
    for phase in ("train.feed", "train.forward", "train.backward", "train.optimizer",
                  "train.wait"):
        got = [s for s in spans if s["name"] == phase]
        assert len(got) == 2 and all(by_index[s["parent"]]["name"] == "train.step"
                                     for s in got), phase
    for inner in ("train.loss", "tower.encode"):
        got = [s for s in spans if s["name"] == inner]
        assert len(got) == 2 and all(by_index[s["parent"]]["name"] == "train.forward"
                                     for s in got), inner


def test_tracing_changes_no_token_and_no_loss(tmp_path):
    def run():
        _, _, tokens = _serve(_model(), "forked")
        model = _model()
        trainer = tt.MultimodalTrainer(model, tt.TrainerConfig(
            training_mode=TrainingMode.ALIGNMENT, learning_rate=1e-2,
            output_dir=str(tmp_path)))
        r = np.random.default_rng(3)
        losses = [float(trainer.train_step(_train_batch(r))["loss"]) for _ in range(3)]
        return tokens, losses

    off = run()
    tracer.enable()
    try:
        on = run()
        assert tracer.spans()
    finally:
        tracer.disable()
    assert on == off


def test_meter_counts_real_tokens(tmp_path, monkeypatch):
    seen = []
    update = profiling.ThroughputMeter.update
    monkeypatch.setattr(profiling.ThroughputMeter, "update",
                        lambda self, tokens: seen.append(tokens) or update(self, tokens))
    trainer = tt.MultimodalTrainer(_model(), tt.TrainerConfig(output_dir=str(tmp_path)))
    trainer.train(iter([_train_batch(np.random.default_rng(4), lens=(30, 7))]), num_steps=1)
    assert seen == [37]


def test_profile_window_exports_the_spans_on_the_trace_clock(traced, tmp_path, monkeypatch):
    monkeypatch.setenv("ENABLE_TORCH_PROFILER", "1")
    trainer = tt.MultimodalTrainer(_model(), tt.TrainerConfig(
        output_dir=str(tmp_path / "run"), profile_start_step=1, profile_num_steps=1))
    r = np.random.default_rng(5)
    trainer.train(iter([_train_batch(r) for _ in range(3)]), num_steps=3)
    (path,) = (tmp_path / "run" / "profile").glob("trace_*.json")
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    # the window holds step 1 alone
    assert [e["args"]["step"] for e in spans if e["name"] == "train.step"] == [1]
    assert {"train.feed", "train.forward", "train.loss", "train.backward",
            "train.optimizer", "train.wait", "tower.encode"} <= {e["name"] for e in spans}
    (fwd,) = [e for e in spans if e["name"] == "train.forward"]
    mms = [e for e in events if e.get("name") == "aten::mm" and e.get("ph") == "X"]
    end = fwd["ts"] + fwd["dur"]
    inside = [e for e in mms if fwd["ts"] <= e["ts"] and e["ts"] + e["dur"] <= end]
    assert inside and len(inside) < len(mms)
