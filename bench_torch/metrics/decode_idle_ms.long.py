"""decode_idle_ms.long: Decode step in the long-rollout cell: device-idle ms of
the traced stretch put down to decode steps and their phases, per decode
step. Moves output_tok_s. Read from the program's spans (progtrace.py)."""

import progtrace


def read(run):
    return progtrace.decode_idle_ms(run)
