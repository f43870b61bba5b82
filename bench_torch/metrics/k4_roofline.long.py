"""k4_roofline.long: Kernel K4 in the long-rollout cell: as k4_roofline.batch
(a forked group's shared pages counted once), a sliding layer's keys only
those inside its window (the architecture's pairs). Moves output_tok_s."""

import readers


def read(run):
    return readers.k4_roofline(run, forks_once=True)
