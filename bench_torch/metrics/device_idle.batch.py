"""device_idle.batch: Device: share of the traced stretch with nothing running
on the card. Moves output_tok_s."""

import readers


def read(run):
    return readers.device_idle(run)
