"""flash_roofline.train: Kernels K1, K2a, K2b (ops/flash_attention.py ->
csrc/flash_fwd.cu, flash_bwd.cu): their bound over their device time in the
traced stretch. Moves train_tok_s."""

import readers


def read(run):
    return readers.flash_roofline(run)
