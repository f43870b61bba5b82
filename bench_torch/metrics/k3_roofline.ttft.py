"""k3_roofline.ttft: Kernel K3 (ops/encoder_attention.py ->
csrc/encoder_attention.cu): its bound over its device time in the traced
stretch. Moves tpot_p90_ms (and TTFT, kept per layer
as ttft_p90_ms.chat)."""

import readers


def read(run):
    return readers.k3_roofline(run)
