"""moe_roofline.long: Kernel grouped experts in the long-rollout cell: the
bound of its launches (route, gate-up, down, combine) over their device time
in the traced stretch, from the experts touched and the assignments the
program counted there. Moves output_tok_s."""

import readers_moe


def read(run):
    return readers_moe.moe_roofline(run)
