"""prefill_span_mfu.ttft: Prefill: model FLOPs of the engine.prefill spans'
prompts and images over the spans' summed time, over 989 TFLOP/s. Moves
tpot_p90_ms. Read from the program's spans (progtrace.py)."""

import progtrace


def read(run):
    return progtrace.prefill_span_mfu(run)
