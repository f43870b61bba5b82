"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips where there is no CUDA device. On a machine
with one (and without JAX), run from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Shapes are small and cover the edges the main path's shapes miss: tiny head
dims, ragged sequences, GQA groups from 1 to 8, empty slots.
"""

import numpy as np
import pytest
import torch

from multimeditron_torch.ops import encoder_attention as enc
from multimeditron_torch.ops import paged_attention as paged

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _assert_close(got, want, dtype):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Dh,kv_len", [
    (2, 5, 4, 8, None), (1, 17, 2, 16, 11), (3, 65, 2, 64, None), (1, 130, 1, 32, 129),
])
def test_encoder_attention_kernel(gen, dtype, B, S, H, Dh, kv_len):
    q, k, v = (torch.randn(B, S, H * Dh, generator=gen, device="cuda", dtype=dtype)
               for _ in range(3))
    before = enc.launches["encoder_attention"]
    got = enc.encoder_attention(q, k, v, H, kv_len=kv_len)
    assert enc.launches["encoder_attention"] == before + 1
    want = enc.encoder_attention_plain(q, k, v, H, Dh ** -0.5, kv_len)
    n = kv_len or S
    _assert_close(got[:, :n], want[:, :n], dtype)


def _paged(gen, dtype, B, H, Hkv, D, P, pm, pages_len, gen_rows, T=16, L=2):
    n_pages = 1 + B * pm
    ids = np.random.default_rng(1).permutation(np.arange(1, n_pages))
    table = np.zeros((B, pm), np.int32)
    for b in range(B):
        need = min(-(-(pages_len[b] + T) // P), pm)
        table[b, :need] = ids[b * pm: b * pm + need]
    plen = torch.tensor(pages_len, dtype=torch.int32, device="cuda")

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    return (randn(B, H, D), randn(L, Hkv, n_pages, P, D), randn(L, Hkv, n_pages, P, D),
            randn(L, B, Hkv, T, D), randn(L, B, Hkv, T, D),
            torch.from_numpy(table).cuda(), plen,
            plen + torch.tensor(gen_rows, dtype=torch.int32, device="cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,Hkv,D,P", [(1, 2, 16, 16), (2, 2, 64, 16), (4, 2, 128, 128),
                                            (8, 1, 128, 64)])
def test_ring_decode_kernel(gen, dtype, group, Hkv, D, P):
    pm = 4
    pages_len = [0, 1, P - 1, P, 2 * P + 3, 4 * P - 16]
    gen_rows = [0, 15, 3, 1, 7, 15]
    args = _paged(gen, dtype, 6, group * Hkv, Hkv, D, P, pm, pages_len, gen_rows)
    for layer in (0, 1):
        got = paged.ring_decode_attention(*args, layer)
        _assert_close(got, paged.ring_decode_attention_plain(*args, layer), dtype)


def test_ring_decode_kernel_skips_poisoned_rows(gen):
    """NaN in rows outside a slot's valid range never reaches its output."""
    q, kp, vp, rk, rv, table, plen, lengths = _paged(
        gen, torch.float32, 3, 4, 2, 64, 16, 3, [5, 16, 0], [2, 0, 4])
    want = paged.ring_decode_attention(q, kp, vp, rk, rv, table, plen, lengths, 0)
    kp[:, :, 0] = float("nan")  # trash page
    vp[:, :, 0] = float("nan")
    for b in range(3):
        rk[:, b, :, int(lengths[b] - plen[b]) + 1:] = float("nan")
        rv[:, b, :, int(lengths[b] - plen[b]) + 1:] = float("nan")
    got = paged.ring_decode_attention(q, kp, vp, rk, rv, table, plen, lengths, 0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fold_kernel(gen, dtype):
    P = 16
    args = _paged(gen, dtype, 5, 4, 2, 64, P, 4, [0, 15, 16, 33, 60], [16, 2, 0, 9, 4])
    _, kp, vp, rk, rv, table, plen, lengths = args
    for rows in (16, 8):
        kk, vk, kt, vt = kp.clone(), vp.clone(), kp.clone(), vp.clone()
        paged.fold_ring_into_pages(kk, vk, rk, rv, table, plen, rows, lengths)
        paged.fold_ring_into_pages_plain(kt, vt, rk, rv, table, plen, rows, lengths)
        torch.cuda.synchronize()
        assert torch.equal(kk[:, :, 1:], kt[:, :, 1:])
        assert torch.equal(vk[:, :, 1:], vt[:, :, 1:])
