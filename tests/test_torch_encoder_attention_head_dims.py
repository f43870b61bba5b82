"""Which head dims the encoder attention kernel (K3) takes, decided on the
host before a launch: float32 any even head dim, bf16 any even head dim up
to 128. The kernel itself is held against its twin on the card
(tests/test_torch_cuda.py)."""

import pytest
import torch

from multimeditron_torch.ops import encoder_attention as enc


@pytest.mark.parametrize("dh", [2, 8, 12, 16, 32, 64, 70, 72, 128])
def test_encoder_attention_head_dims_taken(dh):
    enc.check_kernel_head_dim(torch.bfloat16, dh)
    enc.check_kernel_head_dim(torch.float32, dh)


@pytest.mark.parametrize("dh,dtype,match", [
    (130, torch.bfloat16, "up to 128"),
    (136, torch.bfloat16, "up to 128"),
    (9, torch.float32, "even head dim"),
    (9, torch.bfloat16, "even head dim"),
])
def test_encoder_attention_head_dims_refused(dh, dtype, match):
    with pytest.raises(ValueError, match=match):
        enc.check_kernel_head_dim(dtype, dh)


def test_encoder_attention_f32_takes_head_dims_past_128():
    enc.check_kernel_head_dim(torch.float32, 130)
    enc.check_kernel_head_dim(torch.float32, 256)
