"""queue_wait_ms.ttft: Scheduler (serve/engine.py step -> _admit): mean wait
from a request's due time to the start of the step() call that prefilled it.
Moves tpot_p90_ms (and TTFT, kept per layer as ttft_p90_ms.chat)."""

import readers


def read(run):
    return readers.queue_wait_ms(run)
