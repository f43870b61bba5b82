"""Port parity: the plain twins of K4 (ring decode attention) and K5 (ring
fold) against the JAX Pallas kernels (interpret mode) and XLA references,
f32, on the CPU. Cases follow tests/test_paged_attention.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimeditron_torch.ops import paged_attention as tp
from multimeditron_tpu.ops.paged_attention import (
    fold_ring_into_pages,
    fold_ring_into_pages_pallas,
    ring_decode_attention_pallas,
    ring_decode_attention_xla,
)

TOL = dict(atol=1e-5, rtol=1e-5)


def _ring_case(B, H, Hkv, D, P, pm, pages_len, gen, T=8, n_layers=2, seed=0,
               full_tables=False):
    """Pool + ring where slot b has pages_len[b] tokens in shuffled pages and
    gen[b] in-chunk ring tokens (the query attends over pages_len+gen+1 keys)."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * pm

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    q = normal(B, H, D)
    kp, vp = normal(n_layers, Hkv, n_pages, P, D), normal(n_layers, Hkv, n_pages, P, D)
    rk, rv = normal(n_layers, B, Hkv, T, D), normal(n_layers, B, Hkv, T, D)
    ids = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((B, pm), np.int32)
    for b in range(B):
        used = pm if full_tables else -(-int(pages_len[b]) // P)
        table[b, :used] = ids[b * pm: b * pm + used]
    plen = np.asarray(pages_len, np.int32)
    lengths = plen + np.asarray(gen, np.int32)
    return q, kp, vp, rk, rv, table, plen, lengths


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("pages_len,gen", [
    ([0, 5, 127, 256], [0, 3, 7, 1]),
    ([512, 1, 0, 300], [2, 0, 5, 6]),
    ([0, 0, 0, 0], [0, 0, 0, 0]),     # first decode step everywhere
])
@pytest.mark.parametrize("group,D", [(2, 128), (1, 64), (4, 128)])
def test_ring_twin_matches_pallas_and_xla(pages_len, gen, group, D):
    Hkv, P, pm = 2, 128, 4
    case = _ring_case(len(pages_len), Hkv * group, Hkv, D, P, pm, pages_len, gen)
    li = 1
    got = tp.ring_decode_attention(*_torch(*case), li)
    pallas = ring_decode_attention_pallas(*_jax(*case), jnp.int32(li), interpret=True)
    xla = ring_decode_attention_xla(*_jax(*case), jnp.int32(li))
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    assert tp.launches["ring_decode_attention"] == 0  # CPU tensors take the twin


def test_ring_twin_ignores_keys_past_the_valid_range():
    """Pool rows beyond pages_len and ring rows beyond lengths-pages_len get
    no weight, whatever finite values they hold."""
    case = _ring_case(3, 4, 2, 64, 16, 3, [5, 16, 0], [2, 0, 4], T=16)
    base = tp.ring_decode_attention(*_torch(*case), 0)
    q, kp, vp, rk, rv, table, plen, lengths = case
    kp, vp, rk, rv = kp.copy(), vp.copy(), rk.copy(), rv.copy()
    for b in range(3):
        for pos in range(plen[b], 3 * 16):
            page = table[b, pos // 16]
            if page:
                kp[0, :, page, pos % 16] = 50.0
                vp[0, :, page, pos % 16] = -50.0
        rk[0, b, :, lengths[b] - plen[b] + 1:] = 50.0
        rv[0, b, :, lengths[b] - plen[b] + 1:] = -50.0
    kp[0, :, 0], vp[0, :, 0] = 50.0, -50.0  # trash page
    again = tp.ring_decode_attention(*_torch(q, kp, vp, rk, rv, table, plen, lengths), 0)
    np.testing.assert_allclose(again.numpy(), base.numpy(), **TOL)


def test_fold_twin_roundtrip_matches_xla():
    """Ring rows land at pages_len + r of each slot; rows at positions >=
    lengths are not folded (they go to the trash page)."""
    B, Hkv, D, P, pm, T, L = 3, 2, 16, 32, 4, 8, 2
    case = _ring_case(B, Hkv, Hkv, D, P, pm, [0, 33, 64], [5, 5, 3], T=T,
                      n_layers=L, seed=5, full_tables=True)
    _, kp, vp, rk, rv, table, plen, lengths = case
    rows = 5
    want_k, want_v = fold_ring_into_pages(*_jax(kp, vp, rk, rv, table, plen), rows,
                                          lengths=jnp.asarray(lengths), impl="xla")
    got_k, got_v = tp.fold_ring_into_pages(*_torch(kp, vp, rk, rv, table, plen), rows,
                                           torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_k.numpy()[:, :, 1:], np.asarray(want_k)[:, :, 1:])
    np.testing.assert_array_equal(got_v.numpy()[:, :, 1:], np.asarray(want_v)[:, :, 1:])
    for b in range(B):
        for r in range(lengths[b] - plen[b]):
            pos = plen[b] + r
            np.testing.assert_array_equal(
                got_k.numpy()[:, :, table[b, pos // P], pos % P], rk[:, b, :, r])
    # slot 2 stopped after 3 rows: its 4th ring row was not folded
    pos = plen[2] + 3
    np.testing.assert_array_equal(got_k.numpy()[:, :, table[2, pos // P], pos % P],
                                  kp[:, :, table[2, pos // P], pos % P])


@pytest.mark.parametrize("pages_len,gen", [
    ([0, 5, 250, 384], [8, 3, 8, 0]),    # page crossing; inactive slot
    ([127, 128, 1, 0], [8, 16, 15, 16]),  # spill into the next page, a full ring
])
def test_fold_twin_matches_pallas(pages_len, gen):
    """Page-RMW Pallas fold == the twin on every page but the trash page 0,
    with page-boundary crossings, mid-chunk-deactivated and inactive slots."""
    B, Hkv, D, P, pm, T, L = 4, 2, 128, 128, 4, 16, 2
    case = _ring_case(B, Hkv, Hkv, D, P, pm, pages_len, gen, T=T, n_layers=L,
                      seed=7, full_tables=True)
    _, kp, vp, rk, rv, table, plen, lengths = case
    want_k, want_v = fold_ring_into_pages_pallas(
        *_jax(kp, vp, rk, rv, table, plen), T, jnp.asarray(lengths), interpret=True)
    got_k, got_v = tp.fold_ring_into_pages(*_torch(kp, vp, rk, rv, table, plen), T,
                                           torch.from_numpy(lengths))
    np.testing.assert_array_equal(got_k.numpy()[:, :, 1:], np.asarray(want_k)[:, :, 1:])
    np.testing.assert_array_equal(got_v.numpy()[:, :, 1:], np.asarray(want_v)[:, :, 1:])
    assert tp.launches["fold_ring_into_pages"] == 0


def test_wrappers_reject_bad_input():
    case = _torch(*_ring_case(2, 4, 2, 16, 16, 2, [3, 0], [1, 0]))
    with pytest.raises(ValueError, match="layer_index"):
        tp.ring_decode_attention(*case, 2)
    with pytest.raises(ValueError, match="q must be"):
        tp.ring_decode_attention(case[0][:, :3], *case[1:], 0)
    q, kp, vp, rk, rv, table, plen, lengths = case
    with pytest.raises(ValueError, match="rows"):
        tp.fold_ring_into_pages(kp, vp, rk, rv, table, plen, 9, lengths)
    with pytest.raises(ValueError, match="ring must be"):
        tp.fold_ring_into_pages(kp, vp, rk[:, :1], rv[:, :1], table, plen, 1, lengths)
