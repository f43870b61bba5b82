"""progtrace.py: the program's spans laid over the traced stretch. The
attribution and the readers on a hand-built timeline, each reader's None
where a run holds no spans, and the spans of CPU rehearsals against the
harness's own spans and counts."""

import types

import pytest
import torch

import harness
import progtrace
import readers
import rehearse
import roofline
import spec

SEED = 3_000_000_029


def _span(index, name, t0, t1, parent=None, **attrs):
    return {"index": index, "name": name, "t0_ns": t0, "t1_ns": t1, "parent": parent,
            "thread": 0, "attrs": attrs}


# engine.step > decode.chunk > two decode steps, the chunk's readback, the replay
SERVE_SPANS = [
    _span(0, "engine.step", 0, 1000),
    _span(1, "decode.chunk", 100, 900, 0),
    _span(2, "decode.step", 100, 400, 1, ran=True),
    _span(3, "decode.wait", 100, 150, 2),
    _span(4, "decode.forward", 150, 350, 2),
    _span(5, "decode.step", 400, 700, 1, ran=True),
    _span(6, "decode.wait", 400, 500, 5),
    _span(7, "decode.forward", 500, 650, 5),
    _span(8, "decode.wait", 750, 850, 1),
    _span(9, "engine.replay", 900, 990, 0),
]
# (start, end, kernel, launch): launched in 4, 4, 7, 7 (by its start: no
# launch event), 1 (the chunk's own time), outside every span
SERVE_DEVICE = [(200, 300, "a", 160), (320, 360, "b", 340), (520, 600, "c", 510),
                (610, 640, "d", None), (800, 820, "e", 720), (1100, 1200, "f", 1050)]
SERVE_GAPS = [(300, 320), (360, 520), (600, 610), (640, 800), (820, 1100)]


def _timeline(device, gaps, syncs=()):
    return {"trace_start_ns": 0, "device": device, "gaps": gaps, "syncs": list(syncs)}


def _run(cell, spans_in_stretch=True, timeline=None, busy_ns=0):
    cfg = spec.load_config(spec.load_workload(cell)["config"])
    run = harness.Run(workload=spec.load_workload(cell), cfg=cfg, d=spec.dims(cfg), seed=1,
                      seconds=1.0, trace=True, device=torch.device("cpu"), t_process=0.0)
    run.window = (0.0, 10.0)
    if spans_in_stretch:
        run.stretch = types.SimpleNamespace(
            t0=0.0, t1=2e-6, summary={"timeline": timeline, "busy_s": busy_ns / 1e9})
    return run


def test_attribution_by_hand():
    device, idle = progtrace.attribute(_timeline(SERVE_DEVICE, SERVE_GAPS), SERVE_SPANS)
    assert device == pytest.approx({4: 140e-9, 7: 110e-9, 1: 20e-9, None: 100e-9})
    # a gap goes to the span that launched the kernel ending it
    assert idle == pytest.approx({4: 20e-9, 7: 170e-9, 1: 160e-9, None: 280e-9})
    named = progtrace.by_name(SERVE_SPANS, idle)
    assert named == pytest.approx({"decode.forward": 190e-9, "decode.chunk": 160e-9,
                                   progtrace.OUTSIDE: 280e-9})
    assert progtrace.self_ns(SERVE_SPANS)[1] == 800 - 300 - 300 - 100
    assert progtrace.under(SERVE_SPANS, "decode.step") == {2, 3, 4, 5, 6, 7}


def test_serving_readers_by_hand(monkeypatch):
    monkeypatch.setattr(progtrace, "program_spans", lambda: SERVE_SPANS)
    syncs = [(120, "cudaStreamSynchronize"), (760, "cudaMemcpyAsync"),
             (1060, "cudaStreamSynchronize")]
    run = _run("apertus-8b.chat-img", timeline=_timeline(SERVE_DEVICE, SERVE_GAPS, syncs),
               busy_ns=370)
    # idle under the decode steps (20 + 170 ns) over the stretch's 2 steps
    assert progtrace.decode_idle_ms(run) == pytest.approx(1e3 * 190e-9 / 2)
    note = run.notes["idle_by_span"]
    assert note.startswith("0.000001 s put down (5 gaps") and "less busy 0.000001 s" in note
    assert "outside the program 0.000000" in note
    assert run.notes["syncs"].endswith(
        "{'cudaStreamSynchronize': 2, 'cudaMemcpyAsync': 1}; "
        "by span {'decode.wait': 2, 'outside the program': 1}")
    assert run.notes["launches"].startswith("6 device intervals, 1 with no launch event; "
                                            "outside every engine.step: 1 {'f': 1}")
    # the host's share of each step: (300 - 50) and (300 - 100) ns; the
    # window's spans lie outside the stretch
    run.stretch = None
    assert progtrace.decode_host_ms(run) == pytest.approx(225e-6)
    assert "decode.forward 0.000350" in run.notes["self_ms"]


def test_prefill_and_loss_readers_by_hand(monkeypatch):
    prefills = [_span(0, "engine.step", 0, 5000),
                _span(1, "engine.prefill", 10, 2010, 0, rids=[3, 4], tokens=[300, 280],
                      images=[1, 1]),
                _span(2, "engine.prefill", 2100, 3100, 0, rids=[5], tokens=[1024],
                      images=[0])]
    monkeypatch.setattr(progtrace, "program_spans", lambda: prefills)
    run = _run("apertus-8b.chat-img", spans_in_stretch=False)
    d = run.d
    flops = (roofline.prefill_flops(d, 300, 1) + roofline.prefill_flops(d, 280, 1)
             + roofline.prefill_flops(d, 1024, 0))
    assert progtrace.prefill_span_mfu(run) == pytest.approx(
        100 * flops / roofline.PEAK_BF16 / 3e-6)

    train = [_span(0, "train.step", 0, 1000, step=7, tokens=9, padded=12, images=1),
             _span(1, "train.forward", 100, 600, 0),
             _span(2, "train.loss", 400, 550, 1),
             _span(3, "train.backward", 600, 900, 0)]
    device = [(150, 300, "z", 120), (450, 500, "x", 420), (500, 560, "y", 540),
              (700, 800, "w", 650)]
    monkeypatch.setattr(progtrace, "program_spans", lambda: train)
    run = _run("qwen3-4b.align-train", timeline=_timeline(device, [(300, 450), (560, 700)]),
               busy_ns=360)
    assert progtrace.loss_device_ms(run) == pytest.approx(1e3 * 110e-9)
    assert "train.loss 0.000000" in run.notes["idle_by_span"]


def test_queue_wait_twin_by_hand(monkeypatch):
    """Requests 3 and 4 due at 1 us and 4 us, first prefilled at 10 us (a
    chunked prompt's second chunk later), 5 due before the window, 7 a fork
    with no prefill of its own."""
    spans = [_span(0, "engine.prefill", 10_000, 12_000, rids=[3, 4], tokens=[5, 5],
                   images=[0, 0]),
             _span(1, "engine.prefill", 13_000, 14_000, rids=[4, 5], tokens=[5, 5],
                   images=[0, 0])]
    monkeypatch.setattr(progtrace, "program_spans", lambda: spans)
    run = _run("apertus-8b.chat-img", spans_in_stretch=False)
    run.window = (0.5e-6, 10.0)

    def admitted(rid, due):
        return types.SimpleNamespace(due=due, req=types.SimpleNamespace(request_id=rid))
    run.host_spans = lambda: [{"admitted": [admitted(3, 1e-6), admitted(4, 4e-6)]},
                              {"admitted": [admitted(5, 0.0), admitted(7, 2e-6)]}]
    assert progtrace.queue_wait_ms(run) == pytest.approx(1e3 * (9e-6 + 6e-6) / 2)


def test_timeline_maps_the_profile_onto_the_spans_clock():
    """A profile built by hand: device activity at trace_start_ns + offset,
    each kernel beside the runtime call of its correlation id; the gaps sum
    to the first-to-last stretch less summarize's busy time."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, a, b, dev, i):
        return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=a, end=b),
                                     device_type=dev, id=i, cpu_parent=None)
    events = [ev("aten::mm", 0.5, 3.0, cpu, 11), ev("cudaLaunchKernel", 1.0, 1.5, cpu, 101),
              ev("gemm", 2.0, 4.0, cuda, 101), ev("cudaLaunchKernel", 2.5, 2.7, cpu, 102),
              ev("add", 4.5, 5.0, cuda, 102), ev("cudaMemcpyAsync", 5.1, 6.2, cpu, 103),
              ev("Memcpy DtoH (Device -> Pageable)", 5.5, 6.0, cuda, 103),
              ev("cudaStreamSynchronize", 6.2, 6.3, cpu, 104), ev("relu", 7.0, 7.5, cuda, 999)]
    prof = types.SimpleNamespace(
        events=lambda: events,
        profiler=types.SimpleNamespace(
            kineto_results=types.SimpleNamespace(trace_start_ns=lambda: 10 ** 9)))
    tl = progtrace.timeline(prof)
    base = 10 ** 9
    assert tl["trace_start_ns"] == base
    assert tl["device"] == [(base + 2000, base + 4000, "gemm", base + 1000),
                            (base + 4500, base + 5000, "add", base + 2500),
                            (base + 5500, base + 6000, "Memcpy DtoH (Device -> Pageable)",
                             base + 5100),
                            (base + 7000, base + 7500, "relu", None)]
    assert tl["gaps"] == [(base + 4000, base + 4500), (base + 5000, base + 5500),
                          (base + 6000, base + 7000)]
    assert tl["syncs"] == [(base + 5100, "cudaMemcpyAsync"),
                           (base + 6200, "cudaStreamSynchronize")]
    import devtrace

    s = devtrace.summarize(events, 1.0)
    first_to_last_us = 7.5 - 2.0
    assert sum(b - a for a, b in tl["gaps"]) / 1e3 == pytest.approx(
        first_to_last_us - s["busy_s"] * 1e6)


@pytest.mark.parametrize("cell", ["apertus-8b.chat-img", "apertus-8b.grpo-rollout",
                                  "qwen3-4b.align-train"])
def test_readers_read_nothing_without_spans(cell, monkeypatch):
    """The parent's case: no spans (and, without a device, no timeline)."""
    monkeypatch.setattr(progtrace, "program_spans", lambda: [])
    for run in (_run(cell, timeline=_timeline(SERVE_DEVICE, SERVE_GAPS), busy_ns=370),
                _run(cell, timeline=None), _run(cell, spans_in_stretch=False)):
        for fn in (progtrace.decode_host_ms, progtrace.decode_idle_ms,
                   progtrace.prefill_span_mfu, progtrace.loss_device_ms,
                   progtrace.queue_wait_ms):
            assert fn(run) is None
    for name in ("decode_host_ms.tpot", "decode_host_ms.batch", "decode_idle_ms.tpot",
                 "decode_idle_ms.batch", "prefill_span_mfu.ttft", "loss_device_ms.train"):
        assert harness.metric_reader(name)(_run(cell, spans_in_stretch=False)) is None


@pytest.fixture
def tracer_on():
    from multimeditron_torch.profiling import tracer

    progtrace.enable_tracer()
    try:
        yield tracer
    finally:
        tracer.disable()


def test_each_engine_call_holds_one_engine_step(tracer_on):
    """A traced rehearsal with the program's tracer on: every step() call
    the harness timed holds exactly one ``engine.step`` span, on one clock."""
    out, run = rehearse.rehearse("apertus-8b.chat-img", SEED, seconds=1.5, trace=True,
                                 overrides={"traffic": {"rate_per_s": 10.0}, "trace_s": 0.5})
    steps = [s for s in progtrace.program_spans() if s["name"] == "engine.step"]
    assert run.spans
    for sp in run.spans:
        inside = [s for s in steps if sp["t0"] * 1e9 - 1e3 <= s["t0_ns"]
                  and s["t1_ns"] <= sp["t1"] * 1e9 + 1e3]
        assert len(inside) == 1, sp
    # no device: no timeline, so the device-trace readers read nothing
    assert progtrace.decode_idle_ms(run) is None
    assert progtrace.decode_host_ms(run) > 0
    assert 0 < progtrace.prefill_span_mfu(run) <= 100
    # each prefilled request's first engine.prefill lies inside the step()
    # call that admitted it: the queue-wait twin's start is within the
    # harness's call, after its entry
    first = {}
    for s in progtrace.program_spans():
        if s["name"] == "engine.prefill":
            for rid in s["attrs"]["rids"]:
                first.setdefault(rid, s["t0_ns"])
    admitted = [(sp, r) for sp in run.spans for r in sp["admitted"]]
    assert admitted
    for sp, r in admitted:
        assert sp["t0"] * 1e9 - 1e3 <= first[r.req.request_id] <= sp["t1"] * 1e9 + 1e3


def test_replay_gives_the_harness_decode_batch(tracer_on):
    _, run = rehearse.rehearse("apertus-8b.grpo-rollout", SEED + 1, seconds=1.5)
    spans = progtrace.program_spans()
    by_index = {s["index"]: s for s in spans}
    tokens = steps = 0
    for sp in run.host_spans():
        (step,) = [s for s in spans if s["name"] == "engine.step"
                   and sp["t0"] * 1e9 - 1e3 <= s["t0_ns"] and s["t1_ns"] <= sp["t1"] * 1e9 + 1e3]
        for s in spans:
            root = s
            while root["parent"] is not None:
                root = by_index[root["parent"]]
            if root is not step:
                continue
            if s["name"] == "engine.replay":
                tokens += sum(s["attrs"]["emitted"].values())
            elif s["name"] == "decode.step" and s["attrs"]["ran"]:
                steps += 1
    assert steps > 0 and tokens / steps == pytest.approx(readers.decode_batch(run))


def _host_ops_as_device(real):
    """``progtrace.timeline`` with the profile's top-level host operations
    standing in for device kernels, each launched at its start: a CPU
    profile holds no device activity for the device-trace readers to read."""
    import devtrace

    def timeline(prof):
        tl = real(prof)
        t0 = tl["trace_start_ns"]
        ops = [(e.time_range.start, e.time_range.end, e.name) for e in prof.events()
               if e.cpu_parent is None and e.name.startswith("aten::")]
        ns = [(t0 + int(round(a * 1e3)), t0 + int(round(b * 1e3)), n) for a, b, n in ops]
        _, gaps = devtrace._union([(a, b) for a, b, _ in ns])
        return dict(tl, device=sorted((a, b, n, a) for a, b, n in ns), gaps=gaps)
    return timeline


TRACED = {
    "apertus-8b.chat-img": ("decode_host_ms.tpot", "decode_idle_ms.tpot",
                            "prefill_span_mfu.ttft"),
    "apertus-8b.grpo-rollout": ("decode_host_ms.batch", "decode_idle_ms.batch"),
    "qwen3-4b.align-train": ("loss_device_ms.train",),
}


@pytest.mark.parametrize("cell", list(TRACED))
def test_traced_rehearsal_reads_the_programs_spans(cell, monkeypatch):
    """The measured command's traced run as it stands: set-up turns the
    tracer on and the stretch keeps its timeline, so each reader of the
    program's spans reads a value."""
    from multimeditron_torch.profiling import tracer

    monkeypatch.setattr(progtrace, "timeline", _host_ops_as_device(progtrace.timeline))
    tracer.disable()
    out, run = rehearse.rehearse(cell, SEED + 2, seconds=1.5, trace=True,
                                 overrides={"trace_s": 0.5})
    assert tracer.on and out["correct"], (out, run.notes)
    for name in TRACED[cell]:
        assert name in out["metrics"] and out["metrics"][name]["value"] >= 0, (name, out)
