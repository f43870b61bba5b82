"""decode_mfu.tpot: Decode step (models/llama.py paged S = 1 -> K4, K5;
serve/prng.py): roofline share of the whole decode step in step() calls that
admitted nothing. Moves tpot_p90_ms."""

import readers


def read(run):
    return readers.decode_mfu(run, forks_once=False)
