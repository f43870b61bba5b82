"""k4_roofline.batch: Kernel K4 in the rollout cell: as k4_roofline.tpot, a
forked group's shared pages counted once. Moves output_tok_s."""

import readers


def read(run):
    return readers.k4_roofline(run, forks_once=True)
