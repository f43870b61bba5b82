"""k4_roofline.tpot: Kernel K4 (ops/paged_attention.py -> csrc/ring_decode.cu):
its bound over its device time in the traced stretch, bytes from each live
slot's length. Moves tpot_p90_ms."""

import readers


def read(run):
    return readers.k4_roofline(run, forks_once=False)
