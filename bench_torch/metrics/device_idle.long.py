"""device_idle.long: Device in the long-rollout cell: share of the traced
stretch with nothing running on the card. Moves output_tok_s."""

import readers


def read(run):
    return readers.device_idle(run)
