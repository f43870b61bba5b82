"""decode_mfu.long: Decode step in the long-rollout cell: the roofline share
of whole decode steps in step() calls that admitted nothing, the weight
bytes those of the experts the program counted as touched, a forked group's
shared pages read once. Moves output_tok_s."""

import readers_moe


def read(run):
    return readers_moe.decode_mfu(run)
