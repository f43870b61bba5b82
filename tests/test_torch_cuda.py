"""The port's CUDA kernels against their plain twins, on the card.

Marked ``cuda``: each test skips where there is no CUDA device. On a machine
with one (and without JAX), run from the repository root:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

Shapes are small and cover the edges the main path's shapes miss: tiny head
dims, ragged sequences, GQA groups from 1 to 8 (16 in a verify block of 64
rows per kv head), empty slots, fully masked attention rows, verify rows
that see no key of a split, int8 kernels at ragged row counts, K7d, K7e,
K7c (int8 o, on K7e's kernel), K7b and K7g's projection at the edges of
their wgmma tiles (two runs bitwise equal; K7g's projection bitwise equal
to its twin; each K7c form on its own entry), S = 257 and 196, drowned attention rows, every consume path of K7g and each output type
of K7b, K7c with a float o, K7f against the split pair, K10, the fused tower
under every calibration shape, K9 at ragged N and M, split K and both tile
heights, the grouped-expert kernel at Mellum2's widths (decode loads
over 64, 32 and 4 hot experts, prefill chunks of 1,024 and 1,000 tokens,
one and 8 tokens; bitwise repeatable, a graph replay equal to the eager
call), a quantised decoder on the card against the CPU, the flash
backward at the edges of its tiles (Sq and Skv of 1, 17, 64, 127, 129 and
1,000, a 128-key tile masked, the training layout at 1,024 rows) and its
determinism (two runs bitwise equal), and the sampler kernel's tokens
bitwise equal to the eager int64 chain's (the serving cells' shapes, odd
vocabularies, every key form, NaN, tied and filtered rows, a graph-captured
decode step). Gradients are
compared relative to the largest gradient value (they are not of order 1):
f32 1e-4, bf16 2e-2. Float attention outputs are held max-abs as the other
float kernels (f32 1e-4, bf16 2e-2, outputs of order 1): their P.V and
denominator sums run in another order than the twin's.
"""

import numpy as np
import pytest
import torch

from multimeditron_torch.ops import attention as attn
from multimeditron_torch.ops import encoder_attention as enc
from multimeditron_torch.ops import flash_attention as fl
from multimeditron_torch.ops import paged_attention as paged
from multimeditron_torch.ops import sampling
from multimeditron_torch.ops import vit_int8_fused as v8
from multimeditron_torch.serve import prng

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


# the ViT-L/14 sequence (256 patches + CLS) with every key, a masked tail and
# one key, at the serving batch and alone; head dims 32 and 8 are padded to
# 16-column multiples inside the bf16 kernel
VIT_CASES = [(B, 257, 16 if Dh == 64 else 4, Dh, kv_len)
             for B in (1, 8) for Dh in (64, 32, 8) for kv_len in (257, 200, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,Dh,kv_len", [
    (2, 5, 4, 8, None), (1, 17, 2, 16, 11), (3, 65, 2, 64, None), (1, 130, 1, 32, 129),
    (2, 33, 2, 72, 30), (1, 40, 1, 128, None), *VIT_CASES,
    # even head dims that are not a multiple of 8 (staged by 4-byte loads in bf16)
    (2, 257, 3, 12, 200), (1, 70, 2, 70, None), (2, 19, 5, 2, 7),
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


@pytest.mark.parametrize("Dh", [64, 12])
def test_encoder_attention_kernel_ignores_masked_keys(gen, Dh):
    """NaN in the keys and values at or past kv_len never reaches a row
    below it: the bf16 kernel stages zeros for them and masks their scores."""
    B, S, H, kv_len = 2, 257, 4, 200
    q, k, v = (torch.randn(B, S, H * Dh, generator=gen, device="cuda", dtype=torch.bfloat16)
               for _ in range(3))
    want = enc.encoder_attention(q, k, v, H, kv_len=kv_len)[:, :kv_len]
    k[:, kv_len:] = float("nan")
    v[:, kv_len:] = float("nan")
    got = enc.encoder_attention(q, k, v, H, kv_len=kv_len)[:, :kv_len]
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_encoder_attention_kernel_refuses_head_dims(gen):
    q = torch.randn(1, 9, 2 * 136, generator=gen, device="cuda")
    enc.encoder_attention(q, q, q, 2)  # float32 takes any even head dim
    with pytest.raises(ValueError, match="up to 128"):
        enc.encoder_attention(*(x.bfloat16() for x in (q, q, q)), 2)
    q9 = torch.randn(1, 9, 2 * 9, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="even head dim"):
        enc.encoder_attention(q9, q9, q9, 2)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", [16, 128])
def test_ring_decode_kernel_ragged_slots(gen, dtype, P):
    """Slots whose lengths differ by more than four pages: one empty, one of
    a single key, one that fills its table, so the kernel's splits differ
    from slot to slot; two calls give the same bits."""
    pm = 8
    pages_len = [0, 1, 7 * P + 5, 3, 6 * P, 2 * P - 1, 8 * P - 16, 5]
    gen_rows = [0, 2, 15, 0, 9, 4, 15, 11]
    args = _paged(gen, dtype, 8, 32, 8, 128, P, pm, pages_len, gen_rows)
    before = paged.launches["ring_decode_attention"]
    got = paged.ring_decode_attention(*args, 1)
    assert paged.launches["ring_decode_attention"] == before + 1
    _assert_close(got, paged.ring_decode_attention_plain(*args, 1), dtype)
    assert torch.equal(got, paged.ring_decode_attention(*args, 1))


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
@pytest.mark.parametrize("P", [16, 128])
def test_ring_decode_kernel_window(gen, dtype, P):
    """K4 with a sliding window against its twin: windows that start in an
    earlier page, at a page boundary, inside the ring, and one wider than
    every slot; a slot of one key; pages_len past a 64-key tile. Keys before
    a window's first tile are poisoned: the kernel never loads them."""
    pm = 8
    pages_len = [0, 1, 7 * P + 5, 3, 6 * P, 2 * P - 1, 8 * P - 16, 70]
    gen_rows = [0, 2, 15, 0, 9, 4, 15, 11]
    args = _paged(gen, dtype, 8, 32, 8, 128, P, pm, pages_len, gen_rows)
    q, kp, vp, rk, rv, table, plen, lengths = args
    for window in (4, 13, 64, 100, 1024, 4096):
        want = paged.ring_decode_attention_plain(*args, 1, window=window)
        got = paged.ring_decode_attention(*args, 1, window=window)
        _assert_close(got, want, dtype)
        assert torch.equal(got, paged.ring_decode_attention(*args, 1, window=window))
    # NaN in every page row before each slot's window, rounded down to 64 keys
    window = 70
    clean = paged.ring_decode_attention(*args, 1, window=window)
    kp2, vp2 = kp.clone(), vp.clone()
    for b in range(8):
        first = max(0, int(lengths[b]) + 1 - window)
        for pos in range(min(first // 64 * 64, int(plen[b]))):
            page = int(table[b, pos // P])
            kp2[1, :, page, pos % P] = float("nan")
            vp2[1, :, page, pos % P] = float("nan")
    got = paged.ring_decode_attention(q, kp2, vp2, rk, rv, table, plen, lengths, 1,
                                      window=window)
    torch.cuda.synchronize()
    assert torch.equal(got, clean)
    # no window: K4 as before, whatever the argument's spelling
    assert torch.equal(paged.ring_decode_attention(*args, 1, window=0),
                       paged.ring_decode_attention(*args, 1))


def _experts_case(gen, N, D, F_, E, k, idle=True):
    """Router-like inputs: the top k of a softmax over random scores (expert
    E - 1 chosen by no token when ``idle``), renormalised."""
    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cuda") * scale).bfloat16()

    x = randn(N, D)
    w = (randn(E, F_, D, scale=D ** -0.5), randn(E, F_, D, scale=D ** -0.5),
         randn(E, D, F_, scale=F_ ** -0.5))
    scores = torch.randn(N, E, generator=gen, device="cuda")
    if idle:
        scores[:, E - 1] = -1e9
    top, ids = torch.topk(torch.softmax(scores, dim=-1), k, dim=-1)
    return x, ids, top / top.sum(dim=-1, keepdim=True), w


@pytest.mark.parametrize("N,D,F_,E,k", [
    (128, 2304, 896, 64, 8),    # Mellum2's 128-slot decode step
    (1024, 2304, 896, 64, 8),   # a 1,024-token prefill chunk
    (37, 256, 128, 8, 2),       # ragged rows, an expert past a 64-row tile
    (1, 128, 64, 4, 3),
    (300, 384, 192, 5, 5),      # every expert for every token
])
def test_grouped_experts_kernel(gen, N, D, F_, E, k):
    """The grouped-expert kernel against its twin, with an expert that gets
    no token (except where k = E), its counters, and two runs bitwise equal
    (the route's atomics order rows within an expert at random; a row's
    result does not depend on its neighbours)."""
    from multimeditron_torch.ops import grouped_experts as ge

    x, ids, weights, w = _experts_case(gen, N, D, F_, E, k, idle=k < E)
    stats = torch.zeros(2, dtype=torch.int64, device="cuda")
    before = dict(ge.launches)
    got = ge.grouped_experts(x, ids, weights, *w, stats)
    tile = f"tile{ge.token_tile(N, k, E)}"
    assert ge.launches == {**before, "grouped_experts": before["grouped_experts"] + 1,
                           tile: before[tile] + 1}
    twin_stats = torch.zeros(2, dtype=torch.int64, device="cuda")
    want = ge.grouped_experts_plain(x, ids, weights, *w, twin_stats)
    _assert_close(got, want, torch.bfloat16)
    assert torch.equal(stats, twin_stats)
    assert int(stats[0]) == (E if k == E else len(set(ids.flatten().tolist())))
    assert torch.equal(got, ge.grouped_experts(x, ids, weights, *w))


def _mellum_routing(gen, N, load):
    """(N, 8) expert ids and renormalised weights over Mellum2's 64 experts,
    a softmax top 8 of random scores: "all" over 63 of them (expert 63
    chosen by no token), "32" over 32 (the GRPO cell's load, ~32 rows an
    expert), "hot 4" with experts 0-3 chosen by every token (N rows each:
    at N = 128, several token tiles) and 4 more of experts 4-62."""
    E = 64
    scores = torch.randn(N, E, generator=gen, device="cuda")
    if load == "all":
        scores[:, E - 1] = float("-inf")
    elif load == "32":
        scores[:, torch.randperm(E, generator=gen, device="cuda")[32:]] = float("-inf")
    else:
        scores[:, :4] += 100.0
        scores[:, E - 1] = float("-inf")
    top, ids = torch.topk(torch.softmax(scores, dim=-1), 8, dim=-1)
    return ids, top / top.sum(dim=-1, keepdim=True)


@pytest.mark.parametrize("N,load", [
    (128, "all"),   # a 128-slot decode step over the experts
    (128, "32"),    # the GRPO cell's load
    (128, "hot 4"),  # an expert of 128 rows
    (1024, "all"),  # a prefill chunk
    (1000, "all"),  # a prefill chunk's ragged end
    (1, "all"),     # one token: fewer work tiles than SMs
    (8, "32"),
])
def test_grouped_experts_kernel_at_mellum_widths(gen, N, load):
    """The expert kernel at Mellum2's widths (D 2,304, 64 experts of 896,
    top 8) against its twin within the bf16 tolerance, with row counts that
    are not multiples of 8 and an expert with no rows; its counters equal
    the twin's, its token-tile counter moves, two calls are bitwise equal
    and so is a CUDA graph's replay of the call."""
    from multimeditron_torch.ops import grouped_experts as ge

    E, F_, D = 64, 896, 2304
    w = [torch.randn(*shape, generator=gen, device="cuda").mul_(fan ** -0.5).bfloat16()
         for shape, fan in (((E, F_, D), D), ((E, F_, D), D), ((E, D, F_), F_))]
    x = torch.randn(N, D, generator=gen, device="cuda").bfloat16()
    ids, top = _mellum_routing(gen, N, load)
    counts = torch.bincount(ids.flatten(), minlength=E)
    assert (counts == 0).any() and (counts % 8).any()
    if load == "hot 4":
        assert (counts[:4] == N).all() and N > 64
    stats, twin_stats = (torch.zeros(2, dtype=torch.int64, device="cuda") for _ in range(2))
    tile = f"tile{ge.token_tile(N, 8, E)}"
    before = dict(ge.launches)
    got = ge.grouped_experts(x, ids, top, *w, stats)
    assert ge.launches == {**before, "grouped_experts": before["grouped_experts"] + 1,
                           tile: before[tile] + 1}
    want = ge.grouped_experts_plain(x, ids, top, *w, twin_stats)
    _assert_close(got, want, torch.bfloat16)
    assert torch.equal(stats, twin_stats)
    assert int(stats[0]) == int((counts > 0).sum())
    assert torch.equal(got, ge.grouped_experts(x, ids, top, *w))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ge.grouped_experts(x, ids, top, *w)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = ge.grouped_experts(x, ids, top, *w)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed, got)


def test_grouped_experts_kernel_refuses_what_it_does_not_take(gen):
    from multimeditron_torch.ops import grouped_experts as ge

    x, ids, weights, w = _experts_case(gen, 4, 256, 128, 4, 2)
    with pytest.raises(ValueError, match="bfloat16"):
        ge.grouped_experts(x.float(), ids, weights, *(t.float() for t in w))
    x2, ids2, weights2, w2 = _experts_case(gen, 4, 192, 128, 4, 2)
    with pytest.raises(ValueError, match="D % 128"):
        ge.grouped_experts(x2, ids2, weights2, *w2)


def _k8(gen, dtype, B, H, Hkv, D, P, pm, lengths):
    """One layer's pool where slot b's lengths[b] tokens live in shuffled
    pages (page 0, the trash page, unused)."""
    n_pages = 1 + B * pm
    ids = np.random.default_rng(2).permutation(np.arange(1, n_pages))
    table = np.zeros((B, pm), np.int32)
    for b in range(B):
        used = -(-lengths[b] // P)
        table[b, :used] = ids[b * pm: b * pm + used]

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    return (randn(B, H, D), randn(Hkv, n_pages, P, D), randn(Hkv, n_pages, P, D),
            torch.from_numpy(table).cuda(), torch.tensor(lengths, dtype=torch.int32).cuda())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lengths,group,Hkv,D,P,pm", [
    ([7, 129, 0, 256], 1, 2, 64, 128, 2),       # the JAX test cases
    ([7, 129, 0, 256], 4, 2, 64, 128, 2),
    ([1, 1, 1, 1], 1, 2, 64, 128, 2),           # all slots of length 1
    ([1, 1, 1, 1], 4, 2, 64, 128, 2),
    ([5, 128, 0, 200], 3, 2, 80, 128, 2),       # D = 80
    ([66, 3, 250, 0], 2, 2, 64, 64, 4),
    ([513, 530, 0, 576, 541, 560, 527, 550], 4, 8, 128, 128, 5),  # Llama-3.1-8B serving
    ([4096, 1, 3000, 0], 4, 2, 128, 128, 32),   # many splits
    ([20, 9], 16, 1, 32, 16, 2),                # the largest group
])
def test_paged_attention_kernel(gen, dtype, lengths, group, Hkv, D, P, pm):
    args = _k8(gen, dtype, len(lengths), group * Hkv, Hkv, D, P, pm, lengths)
    before = paged.launches["paged_attention"]
    got = paged.paged_attention(*args)
    assert paged.launches["paged_attention"] == before + 1
    _assert_close(got, paged.paged_attention_plain(*args), dtype)
    for b, n in enumerate(lengths):
        if n == 0:
            assert not got[b].any()  # a slot of length 0 is an exact zero row


def test_paged_attention_kernel_skips_poisoned_rows(gen):
    """NaN in pool rows past a slot's length, in its unused table entries'
    pages and in the trash page never reaches its output."""
    q, kp, vp, table, lengths = _k8(gen, torch.float32, 3, 4, 2, 64, 16, 3, [5, 16, 33])
    want = paged.paged_attention(q, kp, vp, table, lengths)
    kp[:, 0], vp[:, 0] = float("nan"), float("nan")
    for b, n in enumerate(lengths.tolist()):
        page = int(table[b, (n - 1) // 16])
        kp[:, page, (n - 1) % 16 + 1:] = float("nan")
        vp[:, page, (n - 1) % 16 + 1:] = float("nan")
    got = paged.paged_attention(q, kp, vp, table, lengths)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_paged_attention_kernel_refuses_what_it_does_not_take(gen):
    q, kp, vp, table, lengths = _k8(gen, torch.float32, 2, 4, 2, 63, 16, 2, [3, 20])
    with pytest.raises(ValueError, match="even head dim"):
        paged.paged_attention(q, kp, vp, table, lengths)
    q, kp, vp, table, lengths = _k8(gen, torch.float32, 2, 17, 1, 64, 16, 2, [3, 20])
    with pytest.raises(ValueError, match="at most 16"):
        paged.paged_attention(q, kp, vp, table, lengths)
    q, kp, vp, table, lengths = _k8(gen, torch.float32, 2, 4, 2, 64, 16, 2, [3, 20])
    with pytest.raises(ValueError, match="int32"):
        paged.paged_attention(q, kp, vp, table.long(), lengths)


def _verify(gen, dtype, B, group, Hkv, S, D, P, pm, pages_len, gen_rows):
    """A verify block of S rows per head over the _paged pool; gen_rows[b] is
    the ring row of slot b's first block row (g = lengths - pages_len)."""
    args = _paged(gen, dtype, B, group * Hkv, Hkv, D, P, pm, pages_len, gen_rows)
    q = torch.randn(B, group * Hkv, S, D, generator=gen, device="cuda", dtype=dtype)
    return (q,) + args[1:]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,Hkv,S,D,P", [
    (1, 2, 3, 16, 16), (2, 2, 2, 64, 16), (4, 8, 5, 128, 128),  # Llama-3.1-8B, k = 4
    (8, 1, 8, 128, 64), (16, 2, 4, 128, 128),                   # 64 rows per kv head
])
def test_ring_verify_kernel(gen, dtype, group, Hkv, S, D, P):
    """Page lengths of 0, a page boundary and P - 1, where the block's first
    ring row ends split 0 and its other rows open split 1 (the ragged split
    edge: row 0 sees no key of split 1); g = 0 and g > 0."""
    pages_len = [0, 1, P - 1, P, 2 * P + 3, 4 * P - 16]
    gen_rows = [0, 3, 0, 1, 7, 16 - S]
    args = _verify(gen, dtype, 6, group, Hkv, S, D, P, 4, pages_len, gen_rows)
    for layer in (0, 1):
        before = paged.launches["ring_verify_attention"]
        got = paged.ring_verify_attention(*args, layer)
        assert paged.launches["ring_verify_attention"] == before + 1
        _assert_close(got, paged.ring_verify_attention_plain(*args, layer), dtype)


def test_ring_verify_kernel_skips_poisoned_rows(gen):
    """NaN in the trash page and in ring rows past a slot's block never
    reaches its output."""
    q, kp, vp, rk, rv, table, plen, lengths = _verify(
        gen, torch.float32, 3, 2, 2, 3, 64, 16, 3, [5, 16, 0], [2, 0, 4])
    want = paged.ring_verify_attention(q, kp, vp, rk, rv, table, plen, lengths, 0)
    kp[:, :, 0] = float("nan")
    vp[:, :, 0] = float("nan")
    for b in range(3):
        rk[:, b, :, int(lengths[b] - plen[b]) + 3:] = float("nan")
        rv[:, b, :, int(lengths[b] - plen[b]) + 3:] = float("nan")
    got = paged.ring_verify_attention(q, kp, vp, rk, rv, table, plen, lengths, 0)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_ring_verify_kernel_rejects_too_many_rows(gen):
    q, *rest = _verify(gen, torch.float32, 2, 16, 1, 5, 32, 16, 2, [3, 0], [0, 1])
    with pytest.raises(ValueError, match="query rows per kv head"):
        paged.ring_verify_attention(q, *rest, 0)  # 16 heads x 5 rows = 80 > 64


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


# ----------------------------------------------------------------------
# K3 gradient (the CUDA forward's autograd Function)
# ----------------------------------------------------------------------
def _rel_err(got, want):
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    return ((got.float() - want.float()).abs().max() / want.float().abs().max().clamp(min=1)).item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kv_len", [None, 40])
def test_encoder_attention_kernel_gradient(gen, dtype, kv_len):
    B, S, H, Dh = 2, 65, 4, 64
    qkv = [torch.randn(B, S, H * Dh, generator=gen, device="cuda", dtype=dtype).requires_grad_()
           for _ in range(3)]
    do = torch.randn(B, S, H * Dh, generator=gen, device="cuda", dtype=dtype)
    n = kv_len or S
    do[:, n:] = 0  # rows past kv_len are garbage by contract
    before = enc.launches["encoder_attention"]
    out = enc.encoder_attention(*qkv, H, kv_len=kv_len)
    assert out.grad_fn is not None
    assert enc.launches["encoder_attention"] == before + 1
    got = torch.autograd.grad(out, qkv, do)
    want = torch.autograd.grad(enc.encoder_attention_plain(*qkv, H, Dh ** -0.5, kv_len), qkv, do)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= GRAD_TOL[dtype]


# ----------------------------------------------------------------------
# K1 / K2a / K2b flash attention
# ----------------------------------------------------------------------
GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
FLASH_CASES = [
    # B, H, Hkv, Sq, Skv, D, causal, causal_offset, mask
    (2, 4, 2, 200, 200, 64, True, None, None),         # ragged tiles
    (1, 8, 1, 64, 64, 128, True, None, "left"),        # rows with no valid key
    (2, 4, 4, 8, 256, 128, True, None, None),          # end-aligned decode rows
    (1, 6, 2, 100, 130, 64, False, None, "holes"),     # non-causal GQA
    (1, 4, 2, 70, 300, 128, True, 0, "right"),         # explicit offset
    (1, 8, 8, 130, 130, 128, True, -20, None),         # negative offset: empty rows
    # whole and ragged 128-row tiles of the bf16 wgmma kernel
    (1, 4, 2, 128, 128, 64, True, None, None),
    (1, 4, 2, 128, 128, 128, False, None, "holes"),
    (2, 8, 2, 300, 300, 128, True, None, "left"),      # rows with no valid key
    (2, 4, 1, 300, 300, 64, False, None, "right"),
    (2, 8, 2, 333, 517, 128, False, None, "holes"),
    (1, 4, 4, 333, 517, 64, True, None, "left"),       # end-aligned, rows with no valid key
    # the edges of the backward's tiles (64-row query stages, 128-key blocks
    # in K2b; 128-query blocks, 64-key stages in K2a) at GQA groups 1, 4, 8
    (1, 4, 4, 1, 1, 128, True, None, None),            # one query, one key
    (1, 8, 2, 1, 1000, 64, False, None, "right"),      # a decode row over 1,000 keys
    (2, 8, 1, 17, 17, 128, True, None, None),
    (1, 8, 2, 17, 1000, 64, True, None, "tail"),       # end-aligned, masked key tiles
    (1, 4, 1, 64, 127, 128, True, None, "holes"),
    (1, 8, 8, 127, 129, 64, False, None, None),
    (2, 8, 1, 129, 64, 128, True, 0, None),            # Sq > Skv, explicit offset
    (1, 16, 4, 1000, 1000, 128, True, None, "right"),
    (1, 4, 1, 300, 520, 128, True, None, "tile"),      # a 128-key tile entirely masked
    (1, 32, 8, 1024, 1024, 128, True, None, "tail"),   # the training layout, reduced length
]


def _flash_case(gen, dtype, B, H, Hkv, Sq, Skv, D, mask):
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda", dtype=dtype)

    q, k, v = randn(B, H, Sq, D), randn(B, Hkv, Skv, D), randn(B, Hkv, Skv, D)
    kv_mask = None
    if mask is not None:
        kv_mask = torch.ones(B, Skv, dtype=torch.int32, device="cuda")
        if mask == "left":
            kv_mask[:, : Skv // 2] = 0
        elif mask == "right":
            kv_mask[:, Skv - 37:] = 0
        elif mask == "tail":  # right padding from 27/32 of the keys on
            kv_mask[:, Skv * 27 // 32:] = 0
        elif mask == "tile":
            kv_mask[:, 128:256] = 0
        else:
            kv_mask[:, 3:9] = 0
            kv_mask[:, 70:] = 0
    return q, k, v, kv_mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_forward_kernel(gen, dtype, case):
    B, H, Hkv, Sq, Skv, D, causal, off, mask = case
    q, k, v, kv_mask = _flash_case(gen, dtype, B, H, Hkv, Sq, Skv, D, mask)
    before = fl.launches["flash_attention_fwd"]
    o, lse = fl._fwd_kernel(q, k, v, kv_mask, causal, D ** -0.5,
                            Skv - Sq if off is None else off)
    assert fl.launches["flash_attention_fwd"] == before + 1
    o_ref, lse_ref = fl.flash_attention_fwd_plain(q, k, v, kv_mask, causal, causal_offset=off)
    _assert_close(o, o_ref, dtype)
    torch.cuda.synchronize()
    assert torch.equal(lse == fl.MASK_VALUE, lse_ref == fl.MASK_VALUE)
    assert (lse - lse_ref).abs().max().item() <= 1e-3
    assert not o[lse == fl.MASK_VALUE].any()  # no valid key: an exact zero row


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_backward_kernels(gen, dtype, case):
    B, H, Hkv, Sq, Skv, D, causal, off, mask = case
    q, k, v, kv_mask = _flash_case(gen, dtype, B, H, Hkv, Sq, Skv, D, mask)
    offset = Skv - Sq if off is None else off
    o, lse = fl.flash_attention_fwd_plain(q, k, v, kv_mask, causal, causal_offset=off)
    do = torch.randn(o.shape, generator=gen, device="cuda", dtype=dtype)
    got = fl._bwd_kernel(q, k, v, kv_mask, o, lse, do, causal, D ** -0.5, offset)
    want = fl.flash_attention_bwd_plain(q, k, v, kv_mask, o, lse, do, causal,
                                        causal_offset=off)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= GRAD_TOL[dtype]
    if kv_mask is not None:  # masked keys get exactly zero dk and dv
        dead = (kv_mask == 0)[:, None, :, None].expand_as(got[1])
        assert not got[1][dead].any() and not got[2][dead].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_backward_kernels_on_kernel_forward(gen, dtype, case):
    """K2a / K2b fed K1's own o and lse, against the twins' gradients from
    the same o and lse."""
    B, H, Hkv, Sq, Skv, D, causal, off, mask = case
    q, k, v, kv_mask = _flash_case(gen, dtype, B, H, Hkv, Sq, Skv, D, mask)
    offset = Skv - Sq if off is None else off
    o, lse = fl._fwd_kernel(q, k, v, kv_mask, causal, D ** -0.5, offset)
    do = torch.randn(o.shape, generator=gen, device="cuda", dtype=dtype)
    got = fl._bwd_kernel(q, k, v, kv_mask, o, lse, do, causal, D ** -0.5, offset)
    want = fl.flash_attention_bwd_plain(q, k, v, kv_mask, o, lse, do, causal,
                                        causal_offset=off)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= GRAD_TOL[dtype]
    if kv_mask is not None:  # masked keys get exactly zero dk and dv
        dead = (kv_mask == 0)[:, None, :, None].expand_as(got[1])
        assert not got[1][dead].any() and not got[2][dead].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_kernels_are_deterministic(gen, dtype):
    """K2a and K2b sum in a fixed order (no atomics): two runs on the same
    inputs give bitwise-equal dq, dk and dv."""
    B, H, Hkv, S, D = 1, 32, 8, 1024, 128
    q, k, v, kv_mask = _flash_case(gen, dtype, B, H, Hkv, S, S, D, "tail")
    o, lse = fl._fwd_kernel(q, k, v, kv_mask, True, D ** -0.5, 0)
    do = torch.randn(o.shape, generator=gen, device="cuda", dtype=dtype)
    first = fl._bwd_kernel(q, k, v, kv_mask, o, lse, do, True, D ** -0.5, 0)
    second = fl._bwd_kernel(q, k, v, kv_mask, o, lse, do, True, D ** -0.5, 0)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_attention_dispatch_runs_flash_with_autograd(gen):
    B, H, Hkv, S, D = 2, 4, 2, 96, 128
    q, k, v, kv_mask = _flash_case(gen, torch.float32, B, H, Hkv, S, S, D, "right")
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    counts = dict(fl.launches)
    out = attn.attention(q, k, v, kv_mask=kv_mask, causal=True)
    (out.float() ** 2).sum().backward()
    assert {n: fl.launches[n] - counts[n] for n in counts} == {
        "flash_attention_fwd": 1, "flash_attention_bwd_dq": 1, "flash_attention_bwd_dkv": 1}
    ref = [x.detach().requires_grad_() for x in (q, k, v)]
    want = attn.attention_plain(*ref, kv_mask=kv_mask, causal=True)
    (want ** 2).sum().backward()
    _assert_close(out, want, torch.float32)
    for a, b in zip((q, k, v), ref):
        assert _rel_err(a.grad, b.grad) <= GRAD_TOL[torch.float32]
    # a per-sample offset (serving prefill) stays on the plain path
    before = fl.launches["flash_attention_fwd"]
    attn.attention(q.detach(), k.detach(), v.detach(), causal=True,
                   causal_offset=torch.zeros(B, dtype=torch.int32, device="cuda"))
    assert fl.launches["flash_attention_fwd"] == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_forward_decode_form(gen, dtype, D):
    """K1 at Sq = 1, non-causal, with a key mask: a contiguous-cache decode
    step (generate, the slab engine) through the attention dispatcher, at
    ragged lengths (one slot with no valid key)."""
    B, H, Hkv, Skv = 4, 8, 2, 640
    q = torch.randn(B, H, 1, D, generator=gen, device="cuda", dtype=dtype)
    k, v = (torch.randn(B, Hkv, Skv, D, generator=gen, device="cuda", dtype=dtype)
            for _ in range(2))
    lengths = torch.tensor([513, 1, 640, 0], device="cuda")
    kv_mask = torch.arange(Skv, device="cuda")[None, :] < lengths[:, None]
    before = fl.launches["flash_attention_fwd"]
    got = attn.attention(q, k, v, kv_mask=kv_mask, causal=False)
    assert fl.launches["flash_attention_fwd"] == before + 1
    _assert_close(got, attn.attention_plain(q, k, v, kv_mask=kv_mask, causal=False), dtype)
    assert not got[3].any()


def test_flash_wrapper_rejects_unsupported_head_dim(gen):
    q = torch.randn(1, 2, 16, 32, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="head dims"):
        fl.flash_attention(q, q, q)


# ----------------------------------------------------------------------
# K7a / K7c / K7d / K7e / K7g: the fused W8A8 ViT kernels
# ----------------------------------------------------------------------
# int8 outputs: equal on >= 99.5% of elements and never more than 1 apart
# (LayerNorm sums and P.V are taken in another order than the twin's);
# residual outputs: within one ulp of their dtype at their magnitude.
def _assert_int8_close(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.int8 and got.shape == want.shape
    diff = (got.int() - want.int()).abs()
    assert diff.max().item() <= 1
    assert (diff == 0).float().mean().item() >= 0.995


def _assert_within_ulp(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and torch.isfinite(got).all()
    w = want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=1e-30)))) * torch.finfo(want.dtype).eps
    assert ((got.float() - w).abs() <= ulp).all()


def _i8(gen, *shape):
    return torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)


def _unif(gen, lo, hi, *shape):
    return lo + (hi - lo) * torch.rand(*shape, generator=gen, device="cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,D", [(37, 128), (300, 768), (2056, 1024)])
def test_ln_quant_kernel(gen, dtype, M, D):
    x = (3 * torch.randn(M, D, generator=gen, device="cuda") + 0.5).to(dtype)
    w, b = _unif(gen, 0.5, 1.5, D), 0.1 * torch.randn(D, generator=gen, device="cuda")
    before = v8.launches["ln_quant"]
    got = v8.ln_quant(x, w, b, 0.03, 1e-5)
    assert v8.launches["ln_quant"] == before + 1
    _assert_int8_close(got, v8.ln_quant_plain(x, w, b, v8.f32_inv(0.03), 1e-5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name,M,K,D", [
    ("oproj_ln_quant", 45, 1024, 1024),      # ragged 16-row block
    ("fc2_res_ln_quant", 130, 3072, 768),    # SigLIP-base widths
    ("fc2_res_ln_quant", 8500, 512, 256),    # 32-row blocks, ragged
    ("oproj_ln_quant", 17, 256, 256),
])
def test_res_ln_quant_kernels(gen, dtype, name, M, K, D):
    a8, wq = _i8(gen, M, K), _i8(gen, D, K)
    ws = _unif(gen, 0.5, 1.5, D) / (127 * 60 * K ** 0.5)
    bias = 0.1 * torch.randn(D, generator=gen, device="cuda")
    x_res = torch.randn(M, D, generator=gen, device="cuda").to(dtype)
    lnw, lnb = _unif(gen, 0.5, 1.5, D), 0.1 * torch.randn(D, generator=gen, device="cuda")
    fn = getattr(v8, name)
    before = v8.launches[name]
    xo, xq = fn(a8, x_res, wq, ws, bias, lnw, lnb, 1.3, 0.025, 1e-5)
    assert v8.launches[name] == before + 1
    xo_ref, xq_ref = v8.res_ln_quant_plain(a8, x_res, wq, ws, bias, lnw, lnb, 1.3,
                                           v8.f32_inv(0.025), 1e-5)
    _assert_within_ulp(xo, xo_ref)
    _assert_int8_close(xq, xq_ref)


@pytest.mark.parametrize("act", ["quick_gelu_approx", "quick_gelu", "gelu_pytorch_tanh",
                                 "gelu_new", "gelu"])
@pytest.mark.parametrize("M,K,N", [(130, 1024, 4096), (2056, 256, 512), (19, 768, 3072)])
def test_fc1_gelu_quant_kernel(gen, act, M, K, N):
    xq, wq = _i8(gen, M, K), _i8(gen, N, K)
    ws = _unif(gen, 0.5, 1.5, N) / (127 * 40 * K ** 0.5)
    bias = 0.2 * torch.randn(N, generator=gen, device="cuda")
    before = v8.launches["fc1_gelu_quant"]
    got = v8.fc1_gelu_quant(xq, wq, ws, bias, 1.1, 0.04, act)
    assert v8.launches["fc1_gelu_quant"] == before + 1
    _assert_int8_close(got, v8.fc1_gelu_quant_plain(xq, wq, ws, bias, 1.1, v8.f32_inv(0.04), act))


# K7d and K7e on int8 wgmma + TMA, at the edges of their tiles: rows around
# the 64-row warpgroup and 128-row block tiles, the serving batch's 2,056,
# and (K7e) enough rows for 128-row blocks at every width; K = 192 (128
# bytes of K a stage, then a half-empty one), N = 384 (three 128-column
# tiles).
TILE_EDGE_ROWS = [1, 63, 64, 65, 127, 129, 2056]


@pytest.mark.parametrize("act", ["quick_gelu_approx", "quick_gelu", "gelu_pytorch_tanh",
                                 "gelu_new", "gelu"])
@pytest.mark.parametrize("M", TILE_EDGE_ROWS)
def test_fc1_gelu_quant_kernel_tile_edges(gen, act, M):
    K, N = 192, 384
    xq, wq = _i8(gen, M, K), _i8(gen, N, K)
    ws = _unif(gen, 0.5, 1.5, N) / (127 * 40 * K ** 0.5)
    bias = 0.2 * torch.randn(N, generator=gen, device="cuda")
    before = v8.launches["fc1_gelu_quant"]
    got = v8.fc1_gelu_quant(xq, wq, ws, bias, 1.1, 0.04, act)
    assert v8.launches["fc1_gelu_quant"] == before + 1
    _assert_int8_close(got, v8.fc1_gelu_quant_plain(xq, wq, ws, bias, 1.1, v8.f32_inv(0.04), act))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [128, 256, 768, 1024])
@pytest.mark.parametrize("M", TILE_EDGE_ROWS + [16900])
def test_fc2_res_ln_quant_kernel_tile_edges(gen, dtype, D, M):
    K = 192
    a8, wq = _i8(gen, M, K), _i8(gen, D, K)
    ws = _unif(gen, 0.5, 1.5, D) / (127 * 60 * K ** 0.5)
    bias = 0.1 * torch.randn(D, generator=gen, device="cuda")
    x_res = torch.randn(M, D, generator=gen, device="cuda").to(dtype)
    lnw, lnb = _unif(gen, 0.5, 1.5, D), 0.1 * torch.randn(D, generator=gen, device="cuda")
    before = v8.launches["fc2_res_ln_quant"]
    xo, xq = v8.fc2_res_ln_quant(a8, x_res, wq, ws, bias, lnw, lnb, 1.3, 0.025, 1e-5)
    assert v8.launches["fc2_res_ln_quant"] == before + 1
    xo_ref, xq_ref = v8.res_ln_quant_plain(a8, x_res, wq, ws, bias, lnw, lnb, 1.3,
                                           v8.f32_inv(0.025), 1e-5)
    _assert_within_ulp(xo, xo_ref)
    _assert_int8_close(xq, xq_ref)


def test_fc1_and_fc2_kernels_are_deterministic(gen):
    # 16 images of ViT-L/14: K7e in 128-row blocks, K7d over several tiles a block
    M, D, F = 16 * 257, 1024, 4096
    xq, w1, hq, w2 = _i8(gen, M, D), _i8(gen, F, D), _i8(gen, M, F), _i8(gen, D, F)
    w1s, w2s = _unif(gen, 0.5, 1.5, F) / (127 * 40 * D ** 0.5), _unif(gen, 0.5, 1.5, D) / (127 * 60 * F ** 0.5)
    b1, b2 = 0.2 * torch.randn(F, generator=gen, device="cuda"), 0.1 * torch.randn(D, generator=gen, device="cuda")
    x_res = torch.randn(M, D, generator=gen, device="cuda").to(torch.bfloat16)
    lnw, lnb = _unif(gen, 0.5, 1.5, D), 0.1 * torch.randn(D, generator=gen, device="cuda")
    fc1 = lambda: v8.fc1_gelu_quant(xq, w1, w1s, b1, 1.1, 0.04, "quick_gelu_approx")  # noqa: E731
    fc2 = lambda: v8.fc2_res_ln_quant(hq, x_res, w2, w2s, b2, lnw, lnb, 1.3, 0.025, 1e-5)  # noqa: E731
    assert torch.equal(fc1(), fc1())
    (xa, qa), (xb, qb) = fc2(), fc2()
    torch.cuda.synchronize()
    assert torch.equal(xa, xb) and torch.equal(qa, qb)


def test_fc2_and_oproj_run_their_own_kernels(gen, monkeypatch):
    # K7e and K7c with an int8 o reach K7e's wgmma kernel's entry, K7c with a
    # float o keeps res_ln_quant_kernel's
    from multimeditron_torch import _build
    lib, calls = _build.library(), []
    for name in ("mmt_float_res_ln_quant", "mmt_int8_fc2_res_ln_quant"):
        def counted(*args, fn=getattr(lib, name), name=name):
            calls.append(name)
            return fn(*args)
        monkeypatch.setattr(lib, name, counted)
    M, K, D = 300, 1024, 1024
    a8, wq = _i8(gen, M, K), _i8(gen, D, K)
    ws = _unif(gen, 0.5, 1.5, D) / (127 * 60 * K ** 0.5)
    bias = 0.1 * torch.randn(D, generator=gen, device="cuda")
    x_res = torch.randn(M, D, generator=gen, device="cuda").to(torch.bfloat16)
    lnw, lnb = _unif(gen, 0.5, 1.5, D), 0.1 * torch.randn(D, generator=gen, device="cuda")
    args = (a8, x_res, wq, ws, bias, lnw, lnb, 1.3, 0.025, 1e-5)
    before = dict(v8.launches)
    v8.oproj_ln_quant(*args)
    assert calls == ["mmt_int8_fc2_res_ln_quant"]
    assert v8.launches["oproj_ln_quant"] == before["oproj_ln_quant"] + 1
    assert v8.launches["fc2_res_ln_quant"] == before["fc2_res_ln_quant"]
    v8.fc2_res_ln_quant(*args)
    assert calls == ["mmt_int8_fc2_res_ln_quant"] * 2
    assert v8.launches["fc2_res_ln_quant"] == before["fc2_res_ln_quant"] + 1
    assert v8.launches["oproj_ln_quant"] == before["oproj_ln_quant"] + 1
    o = (0.5 * torch.randn(M, K, generator=gen, device="cuda")).to(torch.bfloat16)
    v8.oproj_ln_quant(o, *args[1:])
    assert calls == ["mmt_int8_fc2_res_ln_quant"] * 2 + ["mmt_float_res_ln_quant"]
    assert v8.launches["oproj_ln_quant_float"] == before["oproj_ln_quant_float"] + 1
    assert v8.launches["oproj_ln_quant"] == before["oproj_ln_quant"] + 1


# K7c with an int8 o on K7e's kernel (K = D), at the edges of its 64- and
# 128-row blocks and the serving batch, every width, both residual types
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [128, 256, 768, 1024])
@pytest.mark.parametrize("M", [1, 63, 64, 65, 2056])
def test_oproj_ln_quant_kernel_tile_edges(gen, dtype, D, M):
    a8, wq = _i8(gen, M, D), _i8(gen, D, D)
    ws = _unif(gen, 0.5, 1.5, D) / (127 * 60 * D ** 0.5)
    bias = 0.1 * torch.randn(D, generator=gen, device="cuda")
    x_res = torch.randn(M, D, generator=gen, device="cuda").to(dtype)
    lnw, lnb = _unif(gen, 0.5, 1.5, D), 0.1 * torch.randn(D, generator=gen, device="cuda")
    before = v8.launches["oproj_ln_quant"]
    xo, xq = v8.oproj_ln_quant(a8, x_res, wq, ws, bias, lnw, lnb, 1.3, 0.025, 1e-5)
    assert v8.launches["oproj_ln_quant"] == before + 1
    xo_ref, xq_ref = v8.res_ln_quant_plain(a8, x_res, wq, ws, bias, lnw, lnb, 1.3,
                                           v8.f32_inv(0.025), 1e-5)
    _assert_within_ulp(xo, xo_ref)
    _assert_int8_close(xq, xq_ref)


# The QKV projection (K7g's, and K7b on the same kernel) at the edges of its
# 128 x 128 tiles: rows around one tile, the serving batch's 2,056 and
# 16,900 (more tiles than SMs, each consumer warpgroup several); every
# width (3 D / 128 column tiles, each in one of q, k, v)
QKV_ROWS = [1, 127, 128, 129, 2056, 16900]


def _projection_case(gen, M, D, K):
    xq, wq = _i8(gen, M, K), _i8(gen, 3, D, K)
    ws = _unif(gen, 0.5, 1.5, 3, 1, D) / (127 * 60 * K ** 0.5)
    bias = 0.1 * torch.randn(3, 1, D, generator=gen, device="cuda")
    return xq, wq, ws, bias


@pytest.mark.parametrize("D", [128, 256, 768, 1024])
@pytest.mark.parametrize("M", QKV_ROWS)
def test_qkv_project_kernel_tile_edges(gen, D, M):
    xq, wq, ws, bias = _projection_case(gen, M, D, D)
    scal = (1.0, v8.f32_inv(2.5 / 127), v8.f32_inv(2.0 / 127))
    before = v8.launches["qkv_project"]
    got = v8._qkv_project(xq, wq, ws, bias, *scal)
    assert v8.launches["qkv_project"] == before + 1
    want = v8.qkv_project_plain(xq, wq, ws, bias, *scal)
    torch.cuda.synchronize()
    for g, w in zip(got, want):  # bitwise: the twin's operations, in its order
        assert g.dtype == w.dtype and g.shape == (M, D) and torch.equal(g, w)
    assert want[0].abs().float().mean() > 5  # the case exercises the quantiser


@pytest.mark.parametrize("out", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("D", [128, 256, 768, 1024])
@pytest.mark.parametrize("M", QKV_ROWS)
def test_qkv_int8_kernel_tile_edges(gen, out, D, M):
    # K = 192: a stage of 128 bytes of K, then one of 64
    xq, wq, ws, bias = _projection_case(gen, M, D, 192)
    kw = (dict(qkv_scales=[0.02, 0.03, 0.025]) if out == "int8"
          else dict(out_dtype=getattr(torch, out)))
    before = v8.launches["qkv_int8"]
    got = v8.qkv_int8(xq, wq, ws, bias, 1.3, **kw)
    assert v8.launches["qkv_int8"] == before + 1
    inv3 = [v8.f32_inv(x) for x in kw["qkv_scales"]] if out == "int8" else None
    want = v8.qkv_int8_plain(xq, wq, ws, bias, 1.3, getattr(torch, out), inv3)
    for g, w in zip(got, want):
        assert g.shape == (M, D)
        if out == "int8":
            _assert_int8_close(g, w)
        else:
            _assert_within_ulp(g, w)


def test_qkv_kernels_are_deterministic(gen):
    # 16 images of ViT-L/14: several tiles a consumer warpgroup
    M, D = 16 * 257, 1024
    xq, wq, ws, bias = _projection_case(gen, M, D, D)
    project = lambda: v8._qkv_project(xq, wq, ws, bias, 1.0, 50.0, 60.0)  # noqa: E731
    split = lambda: v8.qkv_int8(xq, wq, ws, bias, 1.3)  # noqa: E731
    for fn in (project, split):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def _qkv_case(gen, B, S, H, shift):
    D = H * 64
    xq, wq = _i8(gen, B, S, D), _i8(gen, 3, D, D)
    ws = _unif(gen, 0.5, 1.5, 3, 1, D) / (127 * 60 * D ** 0.5)
    bias = 0.1 * torch.randn(3, 1, D, generator=gen, device="cuda")
    sq = sk = 2.5 / 127
    scales6 = [1.0, 1 / sq, 1 / sk, shift, sq * sk * 64 ** -0.5, 127 / 0.6]
    return xq, wq, ws, bias, scales6


@pytest.mark.parametrize("B,S,H,kv_len", [
    (3, 257, 16, 257),   # CLIP ViT-L/14
    (2, 196, 12, 196),   # SigLIP base (no CLS)
    (2, 40, 4, 33),      # masked keys
])
def test_qkv_attn_int8_kernel(gen, B, S, H, kv_len):
    xq, wq, ws, bias, scales6 = _qkv_case(gen, B, S, H, shift=6.0)
    before = v8.launches["qkv_attn_int8"]
    got = v8.qkv_attn_int8(xq, wq, ws, bias, scales6, H, kv_len)
    assert v8.launches["qkv_attn_int8"] == before + 1
    want = v8.qkv_attn_int8_plain(xq, wq, ws, bias, scales6, H, kv_len)
    _assert_int8_close(got, want)
    assert want.abs().float().mean() > 1  # the case exercises the quantiser


def test_qkv_attn_int8_kernel_drowned_rows_are_zero(gen):
    # a stabiliser far above every logit underflows all p: 0 through the
    # 1e-30 floor, not NaN
    xq, wq, ws, bias, scales6 = _qkv_case(gen, 2, 50, 4, shift=400.0)
    got = v8.qkv_attn_int8(xq, wq, ws, bias, scales6, 4, 50)
    torch.cuda.synchronize()
    assert not got.any()
    assert not v8.qkv_attn_int8_plain(xq, wq, ws, bias, scales6, 4, 50).any()


def test_int8_kernels_refuse_what_they_do_not_take(gen):
    x = torch.randn(8, 96, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="widths"):
        v8.ln_quant(x, torch.ones(96, device="cuda"), torch.zeros(96, device="cuda"), 0.1, 1e-5)
    xq, wq, ws, bias, scales6 = _qkv_case(gen, 1, 9, 4, 6.0)
    with pytest.raises(ValueError, match="head dim"):
        v8.qkv_attn_int8(xq, wq, ws, bias, scales6, 8, 9)  # 8 heads of 32
    with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
        v8.qkv_attn_int8(xq, wq, ws, bias, scales6, 4, 9, bf16_qk=True)
    # the C entry point refuses a width it was not built for: the wrapper's
    # error check raises
    from multimeditron_torch import _build
    out = torch.empty(8, 96, dtype=torch.int8, device="cuda")
    code = _build.library().mmt_int8_ln_quant(
        x.data_ptr(), x.data_ptr(), x.data_ptr(), out.data_ptr(), 8, 96, 1e-5, 1.0, 0,
        _build.stream_handle(x.device))
    with pytest.raises(RuntimeError, match="CUDA error"):
        _build.check("ln_quant", code)


# the kernels an (L, 8) calibration runs with the forward's defaults
DEFAULT_TOWER = ("ln_quant", "qkv_project", "qkv_attn_int8", "oproj_ln_quant",
                 "fc1_gelu_quant", "fc2_res_ln_quant")


@pytest.mark.parametrize("dtype,tower", [(torch.float32, "clip"), (torch.bfloat16, "clip"),
                                         (torch.bfloat16, "siglip")])
def test_fused_int8_tower_card_matches_cpu(gen, dtype, tower):
    from multimeditron_torch.modalities.image_clip import ImageConfig, ImageModality

    cfg = ImageConfig(model_type="meditron_clip", hidden_size=128, clip_name="", tower=tower,
                      image_size=56, patch_size=14 if tower == "clip" else 8,
                      vision_hidden_size=256, vision_layers=2, vision_heads=4,
                      vision_intermediate_size=512, param_dtype=str(dtype)[6:],
                      wire_dtype="uint8")
    cpu = ImageModality(cfg, device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(0))
    card = ImageModality(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    values = torch.randint(0, 256, (6, 56, 56, 3), dtype=torch.uint8)
    cpu.quantize_params(values[:4], fused=True)
    card.quantize_params(values[:4].cuda(), fused=True)
    before = dict(v8.launches)
    got = card.encode(values.cuda()).float().cpu()
    assert all(v8.launches[n] > before[n] for n in DEFAULT_TOWER)
    assert all(v8.launches[n] == before[n] for n in v8.launches if n not in DEFAULT_TOWER)
    want = cpu.encode(values).float()
    cos = torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), dim=0)
    assert torch.isfinite(got).all() and cos.item() >= 0.999


# ----------------------------------------------------------------------
# K7b, K7c with a float o, K7g's other consume paths, K7f, K10
# ----------------------------------------------------------------------
@pytest.mark.parametrize("out", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("M,D", [(2056, 1024), (130, 768), (19, 128)])
def test_qkv_int8_kernel(gen, out, M, D):
    xq, wq = _i8(gen, M, D), _i8(gen, 3, D, D)
    ws = _unif(gen, 0.5, 1.5, 3, 1, D) / (127 * 60 * D ** 0.5)
    bias = 0.1 * torch.randn(3, 1, D, generator=gen, device="cuda")
    kw = (dict(qkv_scales=[0.02, 0.03, 0.025]) if out == "int8"
          else dict(out_dtype=getattr(torch, out)))
    before = v8.launches["qkv_int8"]
    got = v8.qkv_int8(xq, wq, ws, bias, 1.3, **kw)
    assert v8.launches["qkv_int8"] == before + 1
    inv3 = [v8.f32_inv(x) for x in kw["qkv_scales"]] if out == "int8" else None
    want = v8.qkv_int8_plain(xq, wq, ws, bias, 1.3, getattr(torch, out), inv3)
    for g, w in zip(got, want):
        assert g.shape == (M, D)
        if out == "int8":
            _assert_int8_close(g, w)
        else:
            _assert_within_ulp(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,D", [(45, 1024), (8500, 256), (17, 128)])
def test_oproj_ln_quant_float_o_kernel(gen, dtype, M, D):
    o = (0.5 * torch.randn(M, D, generator=gen, device="cuda")).to(dtype)
    wq = _i8(gen, D, D)
    ws = _unif(gen, 0.5, 1.5, D) / (127 * 60 * D ** 0.5)
    bias = 0.1 * torch.randn(D, generator=gen, device="cuda")
    x_res = torch.randn(M, D, generator=gen, device="cuda").to(dtype)
    lnw, lnb = _unif(gen, 0.5, 1.5, D), 0.1 * torch.randn(D, generator=gen, device="cuda")
    s1 = 1.5 / 127
    before = v8.launches["oproj_ln_quant_float"]
    xo, xq = v8.oproj_ln_quant(o, x_res, wq, ws, bias, lnw, lnb, s1, 0.025, 1e-5)
    assert v8.launches["oproj_ln_quant_float"] == before + 1
    o8 = torch.clamp(torch.round(o.float() * v8.f32_inv(s1)), -127, 127).to(torch.int8)
    xo_ref, xq_ref = v8.res_ln_quant_plain(o8, x_res, wq, ws, bias, lnw, lnb, s1,
                                           v8.f32_inv(0.025), 1e-5)
    _assert_within_ulp(xo, xo_ref)
    _assert_int8_close(xq, xq_ref)


FORMS = {"rowmax": dict(static_smax=False), "static": dict(static_smax=True, fuse_l=False),
         "fused_float": dict(static_smax=True, fuse_l=True)}
FORM_NAMES = {"rowmax": "qkv_attn_int8_rowmax", "static": "qkv_attn_int8_static",
              "fused_float": "qkv_attn_int8_float_out"}


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,kv_len", [(3, 257, 16, 257), (2, 40, 4, 33)])
def test_qkv_attn_int8_consume_paths(gen, form, dtype, B, S, H, kv_len):
    xq, wq, ws, bias, scales6 = _qkv_case(gen, B, S, H, shift=6.0)
    name = FORM_NAMES[form]
    before = v8.launches[name]
    got = v8.qkv_attn_int8(xq, wq, ws, bias, scales6, H, kv_len, out_dtype=dtype, **FORMS[form])
    assert v8.launches[name] == before + 1 and got.dtype == dtype
    mode = {"rowmax": "rowmax", "static": "static", "fused_float": "fused"}[form]
    want = v8.qkv_attn_int8_plain(xq, wq, ws, bias, scales6, H, kv_len, mode=mode,
                                  out_dtype=dtype)
    _assert_close(got[:, :kv_len], want[:, :kv_len], dtype)
    assert want.abs().float().mean() > 0.05


def test_qkv_attn_int8_static_drowned_rows_and_refusals(gen):
    # without fuse_l, a static stabiliser far above every logit still gives 0
    xq, wq, ws, bias, scales6 = _qkv_case(gen, 2, 50, 4, shift=400.0)
    got = v8.qkv_attn_int8(xq, wq, ws, bias, scales6, 4, 50, fuse_l=False,
                           out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all() and not got.any()
    with pytest.raises(ValueError, match="fuse_l"):
        v8.qkv_attn_int8(xq, wq, ws, bias, scales6, 4, 50, fuse_l=False)  # int8 out


def _mlp_case(gen, dtype, M, D, F):
    xq, w1, w2 = _i8(gen, M, D), _i8(gen, F, D), _i8(gen, D, F)
    w1_s = _unif(gen, 0.5, 1.5, F) / (127 * 40 * D ** 0.5)
    b1 = 0.2 * torch.randn(F, generator=gen, device="cuda")
    w2_s = _unif(gen, 0.5, 1.5, D) / (127 * 60 * F ** 0.5)
    b2 = 0.1 * torch.randn(D, generator=gen, device="cuda")
    x_res = torch.randn(M, D, generator=gen, device="cuda").to(dtype)
    lnw, lnb = _unif(gen, 0.5, 1.5, D), 0.1 * torch.randn(D, generator=gen, device="cuda")
    return xq, x_res, w1, w1_s, b1, w2, w2_s, b2, lnw, lnb


@pytest.mark.parametrize("act", ["quick_gelu", "gelu_pytorch_tanh", "gelu"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,D,F", [(2056, 1024, 4096), (130, 768, 3072), (19, 128, 256)])
def test_mlp_fused_kernel(gen, act, dtype, M, D, F):
    args = _mlp_case(gen, dtype, M, D, F)
    scal = (0.04, 0.05, 0.06, 1e-5)
    before = v8.launches["mlp_fused"]
    xo, xq = v8.mlp_fused(*args, *scal, act)
    assert v8.launches["mlp_fused"] == before + 1
    xo_ref, xq_ref = v8.mlp_fused_plain(*args, 0.04, v8.f32_inv(0.05), 0.05, v8.f32_inv(0.06),
                                        1e-5, act)
    _assert_within_ulp(xo, xo_ref)
    _assert_int8_close(xq, xq_ref)
    assert xq_ref.abs().float().mean() > 5
    # the split pair on the card gives the same x'' bits (fc2's int32 sum is
    # exact); K7e's LayerNorm sums run in another order than K7f's, so the
    # int8 row is held to the int8 tolerance
    xq0, x_res, w1, w1_s, b1, w2, w2_s, b2, lnw, lnb = args
    hq = v8.fc1_gelu_quant(xq0, w1, w1_s, b1, 0.04, 0.05, act)
    xo2, xq2 = v8.fc2_res_ln_quant(hq, x_res, w2, w2_s, b2, lnw, lnb, 0.05, 0.06, 1e-5)
    assert torch.equal(xo, xo2)
    _assert_int8_close(xq, xq2)


def test_mlp_fused_refuses_the_approximate_sigmoid(gen):
    args = _mlp_case(gen, torch.bfloat16, 8, 128, 256)
    with pytest.raises(ValueError, match="quick_gelu_approx"):
        v8.mlp_fused(*args, 0.04, 0.05, 0.06, 1e-5, "quick_gelu_approx")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,kv_len", [(3, 257, 16, 257), (2, 40, 4, 33), (1, 24, 1, 20)])
def test_encoder_attention_int8_kernel(gen, dtype, B, S, H, kv_len):
    q, k, v = (_i8(gen, B, S, H * 64) for _ in range(3))
    sq = sk = 2.0 / 127
    qk, pv = sq * sk * 64 ** -0.5, 1.0 / 127 ** 2  # v = v8 / 127: outputs of order 1
    before = enc.launches["encoder_attention_int8"]
    got = enc.encoder_attention_int8(q, k, v, H, qk, pv, kv_len, out_dtype=dtype)
    assert enc.launches["encoder_attention_int8"] == before + 1 and got.dtype == dtype
    want = enc.encoder_attention_int8_plain(q, k, v, H, v8.f32(qk), v8.f32(pv), kv_len, dtype)
    _assert_close(got[:, :kv_len], want[:, :kv_len], dtype)
    assert want.abs().float().mean() > 0.03


@pytest.mark.parametrize("cols,kw,names", [
    (4, {}, ("qkv_int8", "encoder_attention", "oproj_ln_quant_float")),
    (7, {}, ("qkv_attn_int8_rowmax", "oproj_ln_quant_float")),
    (8, dict(int8_o=False), ("qkv_attn_int8_float_out", "oproj_ln_quant_float")),
    (8, dict(fuse_l=False), ("qkv_attn_int8_static", "oproj_ln_quant_float")),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_int8_tower_calibrations_card_matches_cpu(gen, cols, kw, names, dtype):
    from multimeditron_torch.models.vit import ViT, ViTConfig
    from multimeditron_torch.models.vit_quant import calibrate_act_scales, vit_params_tree

    cfg = ViTConfig(image_size=56, patch_size=14, hidden_size=256, num_layers=2, num_heads=4,
                    intermediate_size=512, dtype=dtype)
    vit = ViT(cfg, device="cpu")
    vit.init_weights(torch.Generator().manual_seed(0))
    tree = vit_params_tree(vit)
    pixels = torch.randn(6, 56, 56, 3, generator=torch.Generator().manual_seed(1))
    scales = (calibrate_act_scales(tree, cfg, pixels) if cols == 4
              else v8.calibrate_vit_int8_fused(tree, cfg, pixels)[:, :cols])
    packed = v8.pack_vit_int8_fused(tree)
    want = v8.vit_forward_int8_fused(packed, cfg, pixels, scales, **kw).float()
    card = {k: t.cuda() for k, t in packed.items()}
    before = dict(enc.launches, **v8.launches)
    got = v8.vit_forward_int8_fused(card, cfg, pixels.cuda(), scales.cuda(), **kw).float().cpu()
    after = dict(enc.launches, **v8.launches)
    assert all(after[n] > before[n] for n in names)
    assert (after["qkv_attn_int8"] == before["qkv_attn_int8"]
            and after["oproj_ln_quant"] == before["oproj_ln_quant"])
    cos = torch.nn.functional.cosine_similarity(got.flatten(), want.flatten(), dim=0)
    assert torch.isfinite(got).all() and cos.item() >= 0.999


# ----------------------------------------------------------------------
# K9: the weight-only int8 matmul of the quantised decoder
# ----------------------------------------------------------------------
def _wo_case(gen, dtype, M, K, N):
    from multimeditron_torch.ops import wo_matmul as tw

    x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
    wq = _i8(gen, N, K)
    ws = _unif(gen, 0.5, 1.5, N) * (0.5 / (73 * K ** 0.5))  # outputs of std ~0.5
    return tw, x, wq, ws


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,K,N", [
    (1, 64, 128), (8, 256, 100),      # one chunk; N not a multiple of 8
    (13, 1024, 385), (16, 4096, 4096),  # split K, ragged N and M
    (17, 512, 4096), (40, 448, 6144),   # 64-row tiles (verify), K of 7 chunks
    (300, 192, 200),                   # several m-blocks, ragged
    # token tiles of 128 and 256 (prefill) with ragged M and N, N % 8 != 0
    (65, 256, 200), (128, 1024, 1000), (129, 512, 4100), (257, 192, 385), (600, 640, 520),
    (40, 4096, 28672),                 # verify at the gate-up width
    (1, 14336, 4096), (8, 14336, 4096),  # decode at the down projection's K, split K
])
def test_wo_matmul_kernel(gen, dtype, M, K, N):
    tw, x, wq, ws = _wo_case(gen, dtype, M, K, N)
    before = tw.launches["wo_matmul"]
    got = tw.wo_matmul(x, wq, ws)
    assert tw.launches["wo_matmul"] == before + 1
    assert got.dtype == dtype and got.shape == (M, N)
    _assert_close(got, tw.wo_matmul_plain(x, wq, ws), dtype)


def test_wo_matmul_kernel_is_deterministic_and_takes_leading_dims(gen):
    tw, x, wq, ws = _wo_case(gen, torch.bfloat16, 8, 4096, 4096)
    assert tw.split_k(8, 4096, 4096, 132)[0] > 1  # this shape sums split-K slices
    a = tw.wo_matmul(x, wq, ws)
    b = tw.wo_matmul(x.reshape(2, 4, 4096), wq, ws)
    torch.cuda.synchronize()
    assert b.shape == (2, 4, 4096) and torch.equal(a, b.reshape(8, 4096))


@pytest.mark.parametrize("M,K,N", [(1, 4096, 6144), (40, 4096, 6144), (64, 14336, 4096),
                                   (100, 4096, 4096), (8, 14336, 4096), (3, 1024, 385)])
def test_wo_matmul_kernel_split_sum_is_deterministic(gen, M, K, N):
    """Shapes whose K splits are summed inside the launch: two calls give
    the same bits, and the tile counters are left zero for the next call."""
    tw, x, wq, ws = _wo_case(gen, torch.bfloat16, M, K, N)
    assert tw.split_k(M, K, N, torch.cuda.get_device_properties(0).multi_processor_count)[0] > 1
    a = tw.wo_matmul(x, wq, ws)
    b = tw.wo_matmul(x, wq, ws)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    _assert_close(a, tw.wo_matmul_plain(x, wq, ws), torch.bfloat16)
    from multimeditron_torch import _build
    assert not any(c.any() for c in _build._counters.values())


def test_wo_matmul_kernel_refuses_what_it_does_not_take(gen):
    tw, x, wq, ws = _wo_case(gen, torch.float32, 4, 96, 128)
    with pytest.raises(ValueError, match="multiple of 64"):
        tw.wo_matmul(x, wq, ws)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tw.wo_matmul(torch.randn(4, 64, device="cuda", dtype=torch.float16), wq[:, :64].contiguous(),
                     ws)


@pytest.mark.parametrize("gate", [0, 1])
def test_quantized_llama_card_matches_cpu(gen, gate):
    """A tiny float32 decoder quantised on the CPU and copied to the card:
    W8A16 (K9) and, with the gate open, W8A8 logits agree."""
    from multimeditron_torch.models import llama as tl
    from multimeditron_torch.models import llama_quant as tq
    from multimeditron_torch.ops import wo_matmul as tw

    cfg = tl.LlamaConfig(vocab_size=300, hidden_size=256, intermediate_size=512, num_layers=2,
                         num_heads=4, num_kv_heads=2, dtype=torch.float32)  # head dim 64
    cpu = tl.Llama(cfg, device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(0))
    qcpu = tq.quantize_llama(cpu)
    card = tl.Llama(cfg, device="cuda")
    tq.set_int8_layout(card)
    card.load_state_dict(qcpu.state_dict())
    # 16 rows: at this length no int8 activation code lands on a rounding
    # boundary that the card's and the CPU's float32 sums round apart
    ids = torch.randint(0, 300, (2, 8), generator=torch.Generator().manual_seed(1))
    before = tw.launches["wo_matmul"]
    with torch.inference_mode():
        got, _ = card(input_ids=ids.cuda(), w8a8_min_rows=gate)
        want, _ = qcpu(input_ids=ids, w8a8_min_rows=gate)
    assert tw.launches["wo_matmul"] - before == (1 if gate else 2 * 4 + 1)
    _assert_close(got.cpu(), want, torch.float32)


@pytest.mark.parametrize("spec_k", [0, 2])
def test_slab_engine_card_matches_cpu(gen, spec_k):
    """A tiny float32 model served with kv_mode="slab" on the card and on the
    CPU: equal greedy tokens; on the card every decode step's attention is
    K1 at Sq = 1 and no paged kernel runs."""
    from multimeditron_torch.models.llama import LlamaConfig
    from multimeditron_torch.models.multimodal import MultimodalConfig, MultimodalModel
    from multimeditron_torch.serve.engine import EngineConfig, ServingEngine

    cfg = MultimodalConfig(llm=LlamaConfig(vocab_size=300, hidden_size=256,
                                           intermediate_size=512, num_layers=2, num_heads=4,
                                           num_kv_heads=2, dtype=torch.float32),
                           eos_token_idx=1)  # head dim 64
    cpu = MultimodalModel(cfg, device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(0))
    card = MultimodalModel(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(0)
    batches = []
    for n in (30, 12, 50):
        ids = rng.integers(2, 300, (1, n)).astype(np.int32)
        batches.append({"input_ids": ids, "attention_mask": np.ones_like(ids)})
    ecfg = dict(max_slots=2, max_seq_len=80, prefill_buckets=(16, 32), max_new_tokens=12,
                do_sample=False, kv_mode="slab", speculative_k=spec_k)
    names = ("paged_attention", "ring_decode_attention", "ring_verify_attention",
             "fold_ring_into_pages")
    before = dict(fl.launches), {n: paged.launches[n] for n in names}
    eng = ServingEngine(card, EngineConfig(**ecfg))
    got = eng.generate(batches)
    want = ServingEngine(cpu, EngineConfig(**ecfg)).generate(batches)
    assert got == want
    k1 = fl.launches["flash_attention_fwd"] - before[0]["flash_attention_fwd"]
    assert k1 == (0 if spec_k else 2 * eng.n_decode_steps)
    assert all(paged.launches[n] == before[1][n] for n in names)


def _graph_pair(vocab: int, quantize: bool = False, **kw):
    """A tiny float32 model on the card and two paged engines over it at the
    same settings: the first replays the decode step's CUDA graph, the
    second runs the eager loop."""
    from multimeditron_torch.models.llama import LlamaConfig
    from multimeditron_torch.models.multimodal import MultimodalConfig, MultimodalModel
    from multimeditron_torch.serve.engine import EngineConfig, ServingEngine

    cfg = MultimodalConfig(llm=LlamaConfig(vocab_size=vocab, hidden_size=256,
                                           intermediate_size=512, num_layers=2, num_heads=4,
                                           num_kv_heads=2, dtype=torch.float32),
                           eos_token_idx=10)  # head dim 64
    cpu = MultimodalModel(cfg, device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(0))
    card = MultimodalModel(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    ecfg = EngineConfig(**{**dict(max_slots=3, max_seq_len=47, prefill_buckets=(16, 32),
                                  page_size=16, decode_chunk=4, max_new_tokens=40,
                                  quantize_llm=quantize), **kw})
    graph, eager = ServingEngine(card, ecfg), ServingEngine(card, ecfg)
    eager._graph_key = None  # the eager loop, as off the card
    return graph, eager


def _graph_prompts(vocab: int):
    rng = np.random.default_rng(5)
    out = []
    # the two prompts that reach the cache's end leave 27 and 18 tokens of
    # headroom: chunks of 4, then 2 and 1
    for n in (12, 20, 7, 29, 9):
        ids = rng.integers(2, vocab, (1, n)).astype(np.int32)
        out.append({"input_ids": ids, "attention_mask": np.ones_like(ids)})
    return out


def _serve_pair(eng, prompts, group: bool):
    """Budgets that end mid-chunk, two past the cache (capacity), one greedy
    request in a sampling engine (at vocab 64 it emits EOS, 10, as its
    third token); with ``group`` a forked group of 3."""
    budgets = (5, 40, 9, 40, 13)
    reqs = []
    if group:
        reqs += eng.submit_group(prompts[1], 3, max_new_tokens=11)
    for j, (b, n) in enumerate(zip(prompts, budgets)):
        reqs.append(eng.submit(b, max_new_tokens=n, temperature=0.0 if j == 2 else None))
    eng.run()
    return reqs


def test_moe_decode_graph_matches_eager_loop(gen):
    """A bf16 decoder with sliding windows of 16 keys and 8 experts (2 a
    token) on the card: the replayed decode step (the grouped-expert
    kernel's three launches and the windowed K4 inside the graph) against
    the eager loop, sampled, with a forked group: equal tokens, equal state
    and page pool, equal expert counters; every live step a replay."""
    from multimeditron_torch.models.llama import LlamaConfig
    from multimeditron_torch.models.multimodal import MultimodalConfig, MultimodalModel
    from multimeditron_torch.ops import grouped_experts as ge
    from multimeditron_torch.serve.engine import EngineConfig, ServingEngine

    kinds = ["sliding_attention", "sliding_attention", "full_attention"]
    hf = dict(model_type="mellum", vocab_size=64, hidden_size=256, intermediate_size=512,
              num_hidden_layers=3, num_attention_heads=4, num_key_value_heads=2, head_dim=64,
              layer_types=kinds, mlp_layer_types=["sparse"] * 3, sliding_window=16,
              rope_parameters={"full_attention": {
                  "rope_type": "yarn", "rope_theta": 500000, "factor": 4,
                  "original_max_position_embeddings": 32},
                  "sliding_attention": {"rope_type": "default", "rope_theta": 500000}},
              num_experts=8, num_experts_per_tok=2, moe_intermediate_size=128)
    model = MultimodalModel(MultimodalConfig(llm=LlamaConfig.from_hf_dict(hf),
                                             eos_token_idx=10), device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    ecfg = EngineConfig(max_slots=3, max_seq_len=47, prefill_buckets=(16, 32), page_size=16,
                        decode_chunk=4, max_new_tokens=40, do_sample=True, temperature=1.0,
                        seed=2 ** 31 - 7)
    graph, eager = ServingEngine(model, ecfg), ServingEngine(model, ecfg)
    eager._graph_key = None
    before = ge.launches["grouped_experts"]
    prompts = _graph_prompts(64)
    got = _serve_pair(graph, prompts, group=True)
    launched = ge.launches["grouped_experts"] - before
    want = _serve_pair(eager, prompts, group=True)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    for name in ("length", "pages_length", "active", "remaining", "tokens"):
        assert torch.equal(graph.state[name], eager.state[name]), name
    for name in ("k", "v"):  # every page but the trash page, which nothing reads
        assert torch.equal(graph.state[name][:, :, 1:], eager.state[name][:, :, 1:]), name
    assert graph.n_decode_graph_steps == graph.n_decode_steps > 0
    assert (graph.n_experts_touched, graph.n_expert_assignments) == \
        (eager.n_experts_touched, eager.n_expert_assignments)
    # the graph engine's host launches: 3 a prefill call, 3 in the eager step
    # before the capture and 3 in the capture
    assert launched == 3 * (graph.n_prefill_calls + 2)


@pytest.mark.parametrize("case", ["greedy", "sampled", "forked", "w8a16"])
def test_decode_graph_matches_eager_loop(gen, case):
    """The replayed decode step against the eager loop on the card, at one
    seed: equal tokens and finish reasons, equal final lengths, budgets and
    activity, and an equal page pool after the last fold; every live step
    of the graph engine ran as a replay, over chunks of 4, 2 and 1."""
    vocab = 64
    kw = dict(do_sample=case != "greedy", temperature=1.0, seed=2 ** 31 - 7)
    graph, eager = _graph_pair(vocab, quantize=case == "w8a16", **kw)
    chunks = []
    run_chunk = graph._decode_chunk
    graph._decode_chunk = lambda n: chunks.append(n) or run_chunk(n)
    prompts = _graph_prompts(vocab)
    got = _serve_pair(graph, prompts, group=case == "forked")
    want = _serve_pair(eager, prompts, group=case == "forked")
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
    assert {"eos", "budget", "capacity"} <= {r.finish_reason for r in got}
    for name in ("length", "pages_length", "active", "remaining", "tokens", "k", "v"):
        assert torch.equal(graph.state[name], eager.state[name]), name
    assert graph.n_decode_graph_steps == graph.n_decode_steps > 0
    assert eager.n_decode_graph_steps == 0 and eager.n_decode_steps == graph.n_decode_steps
    assert {1, 2, 4} <= set(chunks)


def test_decode_graph_replay_shows_k4_in_the_profiler(gen):
    """A torch.profiler trace of replays holds K4's device records, one a
    layer of each step; the wrapper's host launch counter stays put, as the
    kernels are launched by the graph."""
    graph, _ = _graph_pair(300, do_sample=True, temperature=0.7)
    prompts = _graph_prompts(300)
    graph.generate(prompts[:2], max_new_tokens=6)  # captures the graph
    before = (paged.launches["ring_decode_attention"], graph.n_decode_steps)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        graph.generate(prompts[2:], max_new_tokens=10)
        torch.cuda.synchronize()
    steps = graph.n_decode_steps - before[1]
    k4 = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
          and "decode_kernel<" in e.name]
    assert steps > 0 and len(k4) == 2 * steps
    assert paged.launches["ring_decode_attention"] == before[0]


def test_captured_launches_get_scratch_of_their_own(gen):
    """While a CUDA graph is captured, K4's and K9's scratch is allocated for
    the graph (zeroed counters at every replay) and is neither taken from
    nor stored in the per-stream tables that eager launches share."""
    from multimeditron_torch import _build

    dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.Stream(dev)
    handle = stream.cuda_stream
    eager = (_build.workspace(dev, handle, 64), _build.zeroed_counters(dev, handle, 8))

    def tables():
        return [{k: v.data_ptr() for k, v in t.items()}
                for t in (_build._workspace, _build._counters)]

    before = tables()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        work = _build.workspace(dev, handle, 64)
        counters = _build.zeroed_counters(dev, handle, 8)
        counters += 1
    assert tables() == before
    assert work.data_ptr() != eager[0].data_ptr()
    assert counters.data_ptr() != eager[1].data_ptr()
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(counters, torch.ones(8, dtype=torch.int32, device=dev))
    assert not eager[1].any()


# ----------------------------------------------------------------------
# The sampler kernel (csrc/gumbel_argmax.cu) against the eager int64 chain on
# the card: equal tokens, bit for bit

SAMPLER_SEEDS = [2 ** 31 - 1, 4_000_000_001 % 2 ** 31, 0, 1, 2, 3, 5, 7, 11, 13, 17, 19, 23, 29,
                 31, 37, 123_456_789, 987_654_321, 2 ** 30, 65_537]


def _sampler_case(gen, rows, V, dtype):
    """Logits of std 3, and temperatures 0, 0.7 and 1.0 in turn."""
    logits = (torch.randn(rows, V, generator=gen, device="cuda") * 3).to(dtype)
    temps = torch.tensor([0.0, 0.7, 1.0], device="cuda").repeat(rows // 3 + 1)[:rows]
    return logits, temps.contiguous()


def _keys(seed, rows, form):
    """A key in each of the forms the engine passes: one on the host (prefill,
    forks, the eager loop), one on the card (the decode graph), one a row on
    the card (the speculative verify's fold_in keys) or on the host."""
    key = prng.split(prng.prng_key(seed))[1]
    if form == "host":
        return key
    if form == "card":
        return key.cuda()
    per_row = prng.fold_in(key, torch.arange(rows) * (1 << 20) + 40)
    return per_row.cuda() if form == "rows on the card" else per_row


@pytest.mark.parametrize("form", ["host", "card", "rows on the card", "rows on the host"])
@pytest.mark.parametrize("rows,V,dtype", [
    (128, 98304, torch.bfloat16), (32, 131072, torch.bfloat16),  # the serving cells' steps
    (7, 1000, torch.float32), (5, 151936, torch.float32),
    (9, 1001, torch.bfloat16), (4, 37, torch.float32),  # rows not 16-byte aligned
])
def test_sampler_kernel_matches_eager_chain(gen, rows, V, dtype, form):
    logits, temps = _sampler_case(gen, rows, V, dtype)
    seeds = SAMPLER_SEEDS if rows * V < 2 ** 22 else SAMPLER_SEEDS[:6]
    before = sampling.launches["gumbel_argmax"]
    for seed in seeds:
        key = _keys(seed, rows, form)
        got = sampling.sample(logits, temps, key)
        assert got.dtype == torch.int32 and got.device == logits.device
        assert torch.equal(got, sampling.sample_plain(logits, temps, key)), seed
        # the plain form over scaled logits, against prng.categorical on the card
        scaled = logits.float() / 0.7
        drawn = sampling.gumbel_argmax(scaled, key)
        assert torch.equal(drawn.long(), prng.categorical(key, scaled)), seed
    assert sampling.launches["gumbel_argmax"] == before + 2 * len(seeds)


def test_sampler_kernel_matches_eager_chain_at_twenty_seeds_on_the_cell_shape(gen):
    """grpo-long's step, 128 x 98,304 bf16, with its key on the card, at 20 seeds."""
    logits, temps = _sampler_case(gen, 128, 98304, torch.bfloat16)
    for seed in SAMPLER_SEEDS:
        key = _keys(seed, 128, "card")
        assert torch.equal(sampling.sample(logits, temps, key),
                           sampling.sample_plain(logits, temps, key)), seed


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sampler_kernel_edge_rows(gen, dtype):
    """Rows of one value everywhere (the first index wins the greedy
    argmax), rows with a NaN (NaN wins both argmaxes, as in torch.argmax),
    and rows filtered to -inf but one column, across block boundaries."""
    rows, V = 12, 5000
    logits, temps = _sampler_case(gen, rows, V, dtype)
    logits[0:3] = 1.5
    logits[3, 4321] = float("nan")
    logits[4, 17] = float("nan")
    logits[4, 2100] = float("nan")
    logits[5, 2047] = float("nan")
    logits[6:9] = float("-inf")
    logits[6, 0] = 2.0
    logits[7, 2048] = -3.0
    logits[8, V - 1] = 0.0
    for seed in SAMPLER_SEEDS:
        for form in ("host", "card", "rows on the card"):
            key = _keys(seed, rows, form)
            got = sampling.sample(logits, temps, key)
            assert torch.equal(got, sampling.sample_plain(logits, temps, key)), (seed, form)
            assert got[0].item() == 0  # greedy over equal logits
            assert got[3:6].tolist() == [4321, 17, 2047]
            assert got[6:9].tolist() == [0, 2048, V - 1]


def test_sampler_refuses_what_it_does_not_take(gen):
    logits, temps = _sampler_case(gen, 4, 64, torch.float32)
    key = _keys(0, 4, "card")
    for bad in (logits.half(), logits[:, ::2], logits[None]):
        with pytest.raises(ValueError):
            sampling.sample(bad, temps, key)
    with pytest.raises(ValueError):
        sampling.sample(logits, temps.cpu(), key)
    with pytest.raises(ValueError):
        sampling.sample(logits, temps, key.to(torch.int32))


def _count_samples(engine):
    """Wrap ``engine._sample``: the list returned grows by one at each call
    made outside a graph capture."""
    calls, sample = [], engine._sample

    def counted(*args, **kw):
        if not torch.cuda.is_current_stream_capturing():
            calls.append(1)
        return sample(*args, **kw)

    engine._sample = counted
    return calls


@pytest.mark.parametrize("vocab", [64, 300])
def test_decode_graph_sampler_matches_the_eager_chain(gen, vocab):
    """The graph engine, whose every draw is the sampler kernel, against the
    eager loop drawing through the eager int64 chain on the card: equal
    tokens and state. ``n_kernel_samples`` counts each eager sampling call
    and each replay; the eager chain's engine counts none."""
    graph, eager = _graph_pair(vocab, do_sample=True, temperature=0.7, seed=2 ** 31 - 7)
    eager._sample = lambda logits, temps, top_ps, key: sampling.sample_plain(
        logits.contiguous(), temps, key)
    calls = _count_samples(graph)
    prompts = _graph_prompts(vocab)
    got = _serve_pair(graph, prompts, group=True)
    want = _serve_pair(eager, prompts, group=True)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    for name in ("length", "active", "remaining", "tokens", "k", "v"):
        assert torch.equal(graph.state[name], eager.state[name]), name
    assert graph.n_decode_graph_steps == graph.n_decode_steps > 0
    assert graph.n_kernel_samples == len(calls) + graph.n_decode_graph_steps
    assert eager.n_kernel_samples == 0


@pytest.mark.parametrize("filters", [{}, {"top_k": 40}])
def test_sampled_speculative_engine_card_matches_cpu(gen, filters):
    """A tiny float32 model served with speculative_k=2 and do_sample=True on
    the card and on the CPU: equal tokens. On the card the verify draws each
    (slot, position) row with its fold_in key through the sampler kernel
    (with top-k: its plain form after the eager filter); on the CPU through
    the int64 twin."""
    from multimeditron_torch.models.llama import LlamaConfig
    from multimeditron_torch.models.multimodal import MultimodalConfig, MultimodalModel
    from multimeditron_torch.serve.engine import EngineConfig, ServingEngine

    cfg = MultimodalConfig(llm=LlamaConfig(vocab_size=300, hidden_size=256,
                                           intermediate_size=512, num_layers=2, num_heads=4,
                                           num_kv_heads=2, dtype=torch.float32),
                           eos_token_idx=1)  # head dim 64
    cpu = MultimodalModel(cfg, device="cpu")
    cpu.init_weights(torch.Generator().manual_seed(0))
    card = MultimodalModel(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(2)
    batches = []
    for n in (30, 12, 50):
        ids = rng.integers(2, 300, (1, n)).astype(np.int32)
        batches.append({"input_ids": ids, "attention_mask": np.ones_like(ids)})
    ecfg = dict(max_slots=3, max_seq_len=96, prefill_buckets=(16, 32, 64), page_size=16,
                max_new_tokens=16, do_sample=True, temperature=0.7, seed=2 ** 31 - 3,
                speculative_k=2, **filters)
    before = sampling.launches["gumbel_argmax"]
    eng = ServingEngine(card, EngineConfig(**ecfg))
    got = eng.generate(batches)
    launched = sampling.launches["gumbel_argmax"] - before
    want = ServingEngine(cpu, EngineConfig(**ecfg)).generate(batches)
    assert got == want
    assert eng.spec_verify_steps > 0
    assert launched == eng.n_kernel_samples >= eng.spec_verify_steps
