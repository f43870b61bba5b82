"""Port parity: the plain twins of K8 (paged decode attention), K4 (ring
decode attention), K6 (ring verify attention) and K5 (ring fold) against the
JAX Pallas kernels (interpret mode) and XLA references, f32 (and K8 in bf16
as well), on the CPU. Cases follow tests/test_paged_attention.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimeditron_torch.ops import paged_attention as tp
from multimeditron_tpu.ops.paged_attention import (
    fold_ring_into_pages,
    fold_ring_into_pages_pallas,
    paged_attention_pallas,
    paged_attention_xla,
    ring_decode_attention_pallas,
    ring_decode_attention_xla,
    ring_verify_attention_pallas,
    ring_verify_attention_xla,
)

TOL = dict(atol=1e-5, rtol=1e-5)
# the verify twin against the JAX verify reference: the bound of the JAX
# package's own verify tests (tests/test_paged_attention.py:328-329)
VERIFY_TOL = dict(atol=2e-5, rtol=2e-5)


def _paged_case(B, H, Hkv, D, P, pm, lengths, seed=0):
    """One layer's pool where slot b's lengths[b] tokens live in shuffled
    pages (page 0, the trash page, never used), as the JAX tests build it."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + B * pm

    def normal(*shape):
        return rng.normal(size=shape).astype(np.float32)

    q, kp, vp = normal(B, H, D), normal(Hkv, n_pages, P, D), normal(Hkv, n_pages, P, D)
    ids = rng.permutation(np.arange(1, n_pages))
    table = np.zeros((B, pm), np.int32)
    pos = 0
    for b in range(B):
        used = -(-int(lengths[b]) // P)
        table[b, :used] = ids[pos: pos + used]
        pos += used
    return q, kp, vp, table, np.asarray(lengths, np.int32)


# every case of tests/test_paged_attention.py:48-90: (lengths, group, D, P,
# pages_max, dtype), two kv heads
PAGED_CASES = [
    ([7, 129, 0, 256], 1, 64, 128, 2, "float32"),
    ([7, 129, 0, 256], 4, 64, 128, 2, "float32"),
    ([1, 1, 1, 1], 1, 64, 128, 2, "float32"),
    ([1, 1, 1, 1], 4, 64, 128, 2, "float32"),
    ([5, 128, 0, 200], 1, 64, 128, 2, "float32"),
    ([5, 128, 0, 200], 4, 64, 128, 2, "float32"),
    ([5, 128, 0, 200], 2, 128, 128, 2, "float32"),
    ([5, 128, 0, 200], 3, 80, 128, 2, "float32"),
    ([66, 3, 250, 0], 2, 64, 64, 4, "bfloat16"),
]


@pytest.mark.parametrize("lengths,group,D,P,pm,dtype", PAGED_CASES)
def test_paged_twin_matches_pallas_and_xla(lengths, group, D, P, pm, dtype):
    """K8's twin against the JAX XLA reference and the Pallas kernel in
    interpret mode; slots of length 0 return exact zeros. bf16 inputs are
    held at the JAX bf16 test's bound (tests/test_paged_attention.py:87)."""
    Hkv = 2
    q, kp, vp, table, lens = _paged_case(len(lengths), Hkv * group, Hkv, D, P, pm, lengths)
    tol = TOL
    if dtype == "bfloat16":
        q, kp, vp = (a.astype(jnp.bfloat16) for a in (q, kp, vp))
        tol = dict(atol=3e-2, rtol=3e-2)
    tq, tkp, tvp = (torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch, dtype))
                    for a in (q, kp, vp))
    got = tp.paged_attention(tq, tkp, tvp, torch.from_numpy(table), torch.from_numpy(lens))
    assert got.dtype == tq.dtype
    got = got.float().numpy()
    jargs = (*_jax(q, kp, vp), jnp.asarray(table), jnp.asarray(lens))
    xla = np.asarray(paged_attention_xla(*jargs), np.float32)
    pallas = np.asarray(paged_attention_pallas(*jargs, interpret=True), np.float32)
    np.testing.assert_allclose(got, xla, **tol)
    np.testing.assert_allclose(got, pallas, **tol)
    for b, n in enumerate(lengths):
        if n == 0:
            assert not got[b].any()
    assert tp.launches["paged_attention"] == 0  # CPU tensors take the twin


def test_paged_twin_ignores_keys_past_the_length():
    """Pool rows at positions >= lengths[b] and the trash page get no weight,
    whatever finite values they hold."""
    q, kp, vp, table, lens = _paged_case(3, 4, 2, 32, 16, 3, [5, 16, 33])
    base = tp.paged_attention(*_torch(q, kp, vp, table, lens))
    kp, vp = kp.copy(), vp.copy()
    for b in range(3):
        for pos in range(lens[b], 3 * 16):
            page = table[b, pos // 16]
            if page:
                kp[:, page, pos % 16] = 50.0
                vp[:, page, pos % 16] = -50.0
    kp[:, 0], vp[:, 0] = 50.0, -50.0
    again = tp.paged_attention(*_torch(q, kp, vp, table, lens))
    np.testing.assert_allclose(again.numpy(), base.numpy(), **TOL)


def test_paged_wrapper_rejects_bad_input():
    q, kp, vp, table, lens = _torch(*_paged_case(2, 4, 2, 16, 16, 2, [3, 0]))
    with pytest.raises(ValueError, match="pools"):
        tp.paged_attention(q, kp[None], vp[None], table, lens)
    with pytest.raises(ValueError, match="disagree"):
        tp.paged_attention(q[:, :3], kp, vp, table, lens)
    with pytest.raises(ValueError, match="page_table"):
        tp.paged_attention(q, kp, vp, table[:1], lens)
    with pytest.raises(ValueError, match="dtype"):
        tp.paged_attention(q.double(), kp, vp, table, lens)


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


def _verify_case(B, group, Hkv, D, P, pm, pages_len, gen, S, T=16, seed=0):
    """A verify block of S query rows per head over the _ring_case pool;
    gen[b] = lengths - pages_len, the ring row of the block's first query
    (0 in the engine, which folds the ring after every verify step)."""
    _, kp, vp, rk, rv, table, plen, lengths = _ring_case(
        B, Hkv * group, Hkv, D, P, pm, pages_len, gen, T=T, seed=seed)
    q = np.random.default_rng(seed + 100).normal(size=(B, Hkv * group, S, D)).astype(np.float32)
    return q, kp, vp, rk, rv, table, plen, lengths


@pytest.mark.parametrize("pages_len,gen", [
    ([0, 5, 127, 256], [0, 0, 0, 0]),     # the JAX test cases: g = 0
    ([384, 1, 0, 300], [0, 0, 0, 0]),
    ([0, 5, 127, 256], [3, 0, 7, 1]),     # ring rows already in use: g > 0
    ([0, 0, 0, 0], [0, 2, 0, 9]),         # no page keys at all
])
@pytest.mark.parametrize("group,S", [(2, 5), (4, 3), (1, 4)])
def test_verify_twin_matches_xla(pages_len, gen, group, S):
    case = _verify_case(len(pages_len), group, 2, 64, 128, 3, pages_len, gen, S)
    got = tp.ring_verify_attention(*_torch(*case), 1)
    want = ring_verify_attention_xla(*_jax(*case), jnp.int32(1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VERIFY_TOL)
    assert tp.launches["ring_verify_attention"] == 0  # CPU tensors take the twin


@pytest.mark.parametrize("pages_len,gen", [
    ([0, 5, 127, 256], [0, 0, 0, 0]),
    ([512, 1, 0, 300], [0, 0, 0, 0]),
    ([512, 130, 0, 256], [4, 1, 0, 2]),
])
@pytest.mark.parametrize("group,S,D", [(2, 5, 128), (4, 3, 128)])
def test_verify_twin_matches_pallas(pages_len, gen, group, S, D):
    case = _verify_case(len(pages_len), group, 2, D, 128, 4, pages_len, gen, S, seed=3)
    got = tp.ring_verify_attention(*_torch(*case), 0)
    want = ring_verify_attention_pallas(*_jax(*case), jnp.int32(0), interpret=True,
                                        pages_group=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **VERIFY_TOL)


def test_verify_twin_masks_ring_rows_per_query_row():
    """Query row s sees ring rows <= g + s: changing ring row g + s + 1
    leaves rows <= s unchanged and moves row s + 1; rows past the block are
    never seen."""
    g, S = [2, 0, 5], 4
    case = _verify_case(3, 2, 2, 32, 16, 3, [5, 16, 0], g, S, seed=9)
    base = tp.ring_verify_attention(*_torch(*case), 0).numpy()
    q, kp, vp, rk, rv, table, plen, lengths = case
    for s in range(S - 1):
        rk2, rv2 = rk.copy(), rv.copy()
        for b in range(3):
            rk2[0, b, :, g[b] + s + 1] = 30.0
            rv2[0, b, :, g[b] + s + 1] = -30.0
        again = tp.ring_verify_attention(
            *_torch(q, kp, vp, rk2, rv2, table, plen, lengths), 0).numpy()
        np.testing.assert_allclose(again[:, :, :s + 1], base[:, :, :s + 1], **TOL)
        assert not np.allclose(again[:, :, s + 1], base[:, :, s + 1])
    rk2, rv2 = rk.copy(), rv.copy()
    for b in range(3):
        rk2[0, b, :, g[b] + S:] = 50.0
        rv2[0, b, :, g[b] + S:] = -50.0
    again = tp.ring_verify_attention(*_torch(q, kp, vp, rk2, rv2, table, plen, lengths), 0)
    np.testing.assert_allclose(again.numpy(), base, **TOL)


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
    with pytest.raises(ValueError, match="q must be"):
        tp.ring_verify_attention(case[0], *case[1:], 0)  # (B, H, D) has no block axis
    with pytest.raises(ValueError, match="layer_index"):
        tp.ring_verify_attention(case[0][:, :, None], *case[1:], 2)
    q, kp, vp, rk, rv, table, plen, lengths = case
    with pytest.raises(ValueError, match="rows"):
        tp.fold_ring_into_pages(kp, vp, rk, rv, table, plen, 9, lengths)
    with pytest.raises(ValueError, match="ring must be"):
        tp.fold_ring_into_pages(kp, vp, rk[:, :1], rv[:, :1], table, plen, 1, lengths)
