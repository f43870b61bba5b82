"""decode_batch.long: Scheduler in the long-rollout cell: decode tokens emitted
per decode step, the mean live slots. Moves output_tok_s."""

import readers


def read(run):
    return readers.decode_batch(run)
