"""ttft_p90_ms.chat: Scheduler (serve/engine.py step -> _admit, the wait
for the decode call in flight, then the prefill): p90 of TTFT from each
request's due time, over the window's requests due before the traced
stretch. Kept per layer: its runs spread too widely for an end-to-end
bound. Moves tpot_p90_ms."""

import readers


def read(run):
    return readers.ttft_p90_ms(run)
