"""prefill_mfu.ttft: Prefill (models/multimodal.py embed ->
modalities/image_clip.py -> models/llama.py prefill): model FLOPs of the
prompts prefilled over the prefill spans, over 989 TFLOP/s. Moves
tpot_p90_ms (and TTFT, kept per layer as ttft_p90_ms.chat)."""

import readers


def read(run):
    return readers.prefill_mfu(run)
