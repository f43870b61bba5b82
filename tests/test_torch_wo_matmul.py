"""Port parity: the weight-only int8 matmul (K9's twin), the W8A8 row
quantiser and the W8A8 product against the JAX package, on the CPU.

The port keeps int8 weights (N, K), K contiguous; the JAX package keeps
(K, N), so the tests transpose. Inputs are seeded numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimeditron_torch.ops import wo_matmul as tw
from multimeditron_tpu.ops import wo_matmul as jw

# Relative to the output's largest magnitude: float32 sums in another order
# than XLA; bf16 outputs are one bf16 rounding of nearly equal float32 sums.
REL_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _case(M, K, N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(M, K)).astype(np.float32)
    w_q = rng.integers(-127, 128, (K, N)).astype(np.int8)
    w_s = (rng.uniform(0.5, 1.5, N) / (73 * np.sqrt(K))).astype(np.float32)
    return x, w_q, w_s


def _torch(x, w_q, w_s, dtype):
    return (torch.from_numpy(x).to(getattr(torch, dtype)),
            torch.from_numpy(np.ascontiguousarray(w_q.T)), torch.from_numpy(w_s))


def _jax(x, w_q, w_s, dtype):
    return jnp.asarray(x).astype(getattr(jnp, dtype)), jnp.asarray(w_q), jnp.asarray(w_s)


def _assert_rel(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= REL_TOL[dtype] * np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [64, 256])
@pytest.mark.parametrize("N", [128, 384])
@pytest.mark.parametrize("M", [1, 8, 40, 256])
def test_wo_matmul_matches_jax_xla_and_pallas(M, N, K, dtype):
    x, w_q, w_s = _case(M, K, N, seed=M + N + K)
    before = tw.launches["wo_matmul"]
    got = tw.wo_matmul(*_torch(x, w_q, w_s, dtype))
    assert tw.launches["wo_matmul"] == before  # a CPU tensor runs the twin
    assert got.dtype == getattr(torch, dtype) and got.shape == (M, N)
    got = got.float().numpy()
    jx = _jax(x, w_q, w_s, dtype)
    _assert_rel(got, jw.wo_matmul(*jx, impl="xla").astype(jnp.float32), dtype)
    _assert_rel(got, jw.wo_matmul_pallas(*jx, interpret=True).astype(jnp.float32), dtype)


def test_wo_matmul_keeps_leading_dims_and_refuses_bad_weights():
    x, w_q, w_s = _case(6, 64, 128)
    tx, tq, ts = _torch(x.reshape(2, 3, 64), w_q, w_s, "float32")
    assert tw.wo_matmul(tx, tq, ts).shape == (2, 3, 128)
    with pytest.raises(ValueError, match="int8"):
        tw.wo_matmul(tx, tq.float(), ts)
    with pytest.raises(ValueError, match="scales"):
        tw.wo_matmul(tx, tq, ts[:5])


LLAMA_8B = [(4096, 6144), (4096, 4096), (4096, 28672), (14336, 4096), (4096, 128256)]


def test_split_k_fills_the_card_and_covers_k():
    # every Llama-3.1-8B projection (qkv, o, gate-up, down, lm_head) at decode,
    # verify, a ragged prefill tail and the W8A16 prefill, and a toy shape
    for M, (K, N) in [(M, kn) for M in (1, 8, 40, 64, 100, 4096) for kn in LLAMA_8B] + \
            [(3, (64, 100))]:
        splits, per = tw.split_k(M, K, N, 132)
        chunks = K // tw.K_CHUNK
        assert (splits - 1) * per < chunks <= splits * per  # the splits cover K, none empty
        assert per >= min(tw.MIN_CHUNKS, chunks)
        tiles = -(-M // tw.token_tile(M)) * -(-N // tw.BLOCK_N)
        if tiles >= 132:  # the column tiles alone fill the card: no split
            assert splits == 1
        # no other split count (of at least MIN_CHUNKS chunks) has fewer
        # rounds x (chunks + UNIT_COST) on 132 SMs
        cost = -(-tiles * splits // 132) * (per + tw.UNIT_COST)
        for want in range(1, max(1, chunks // tw.MIN_CHUNKS) + 1):
            p = -(-chunks // want)
            assert -(-tiles * -(-chunks // p) // 132) * (p + tw.UNIT_COST) >= cost
    # o and down at decode split K to fill the card; the lm_head does not
    assert tw.split_k(8, 4096, 4096, 132)[0] > 1 and tw.split_k(8, 14336, 4096, 132)[0] > 1
    assert tw.split_k(8, 4096, 128256, 132)[0] == 1


def test_token_tile_holds_m_in_the_fewest_tokens():
    for M in range(1, 600):
        tile = tw.token_tile(M)
        assert tile in (8, 16, 32, 64, 128, 256)
        if M <= 128:  # one token tile holds M, and no smaller tile would
            assert M <= tile and (tile == 8 or M > tile // 2 or tile == 128 and M > 64)
        else:
            assert tile == 256
    assert [tw.token_tile(M) for M in (1, 8, 9, 40, 64, 65, 4096)] == [8, 8, 16, 64, 64, 128, 256]


def test_quantize_rows_bitwise_equal_to_jax():
    rng = np.random.default_rng(3)
    for dtype in ("float32", "bfloat16"):
        x = (rng.normal(size=(2, 37, 96)) * rng.uniform(0.01, 5, (2, 37, 1))).astype(np.float32)
        x[0, 3] = 0.0  # an all-zero row: the 1e-6 floor
        q, s = tw.quantize_rows(torch.from_numpy(x).to(getattr(torch, dtype)))
        jq, js = jw.quantize_rows(jnp.asarray(x).astype(getattr(jnp, dtype)))
        assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (2, 37, 1)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
def test_w8a8_matmul_within_one_ulp_of_jax(out_dtype):
    rng = np.random.default_rng(4)
    M, K, N = 48, 256, 384
    x = rng.normal(size=(M, K)).astype(np.float32)
    w_q = rng.integers(-127, 128, (K, N)).astype(np.int8)
    w_s = (rng.uniform(0.5, 1.5, N) / (73 * np.sqrt(K))).astype(np.float32)
    x_q, x_s = tw.quantize_rows(torch.from_numpy(x))
    before = tw.launches["w8a8_matmul"]
    got = tw.w8a8_matmul(x_q.reshape(4, 12, K), x_s.reshape(4, 12, 1),
                         torch.from_numpy(np.ascontiguousarray(w_q.T)), torch.from_numpy(w_s),
                         getattr(torch, out_dtype))
    assert tw.launches["w8a8_matmul"] == before + 1
    assert got.shape == (4, 12, N) and got.dtype == getattr(torch, out_dtype)
    want = np.asarray(jw.w8a8_matmul(jnp.asarray(x_q.numpy()), jnp.asarray(x_s.numpy()),
                                     jnp.asarray(w_q), jnp.asarray(w_s),
                                     getattr(jnp, out_dtype)).astype(jnp.float32))
    got = got.float().numpy().reshape(M, N)
    ulp = np.spacing(np.abs(want).astype(getattr(np, "float32")))
    if out_dtype == "bfloat16":
        ulp = ulp * 2.0 ** 16  # bf16 keeps 16 fewer mantissa bits
    assert (np.abs(got - want) <= ulp).all()

