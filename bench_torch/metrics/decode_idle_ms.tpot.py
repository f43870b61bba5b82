"""decode_idle_ms.tpot: Decode step: device-idle ms of the traced stretch put
down to decode steps and their phases, per decode step. Moves tpot_p90_ms.
Read from the program's spans (progtrace.py)."""

import progtrace


def read(run):
    return progtrace.decode_idle_ms(run)
