"""decode_mfu.batch: Decode step in the rollout cell: as decode_mfu.tpot, a
forked group's shared prompt pages read once. Moves output_tok_s."""

import readers


def read(run):
    return readers.decode_mfu(run, forks_once=True)
