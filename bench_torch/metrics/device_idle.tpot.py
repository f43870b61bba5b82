"""device_idle.tpot: Device: share of the traced stretch with nothing running
on the card. Moves tpot_p90_ms."""

import readers


def read(run):
    return readers.device_idle(run)
