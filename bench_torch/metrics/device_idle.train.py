"""device_idle.train: Device: share of the traced stretch with nothing running
on the card. Moves train_tok_s."""

import readers


def read(run):
    return readers.device_idle(run)
