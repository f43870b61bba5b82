"""Port parity: flash attention (K1 forward, K2a/K2b backward) on the CPU,
where the wrapper runs its plain twins, against the JAX Pallas kernels in
interpret mode and the XLA reference. Every case of
tests/test_flash_attention.py is repeated at its own tolerances (2e-5
forward, 5e-4 gradients, 2e-2 bf16), plus the base-2 lse and the backward
twin against autograd of the forward twin."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimeditron_torch.ops import flash_attention as tf
from multimeditron_tpu.ops.attention import attention_xla
from multimeditron_tpu.ops.flash_attention import _fwd, flash_attention

FA = functools.partial(flash_attention, interpret=True)
FWD = dict(atol=2e-5, rtol=2e-5)
GRAD = dict(atol=5e-4, rtol=5e-4)


def _make(B=2, H=4, Hkv=2, Sq=256, Skv=256, D=64, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, H, Sq, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32),
            rng.normal(size=(B, Hkv, Skv, D)).astype(np.float32))


def _left_pad(B, Skv, n):
    return np.broadcast_to((np.arange(Skv)[None, :] >= n).astype(np.int32), (B, Skv)).copy()


def _port(q, k, v, kv_mask=None, dtype=torch.float32, **kw):
    t = [torch.from_numpy(x).to(dtype) for x in (q, k, v)]
    mask = None if kv_mask is None else torch.from_numpy(kv_mask)
    return tf.flash_attention(*t, kv_mask=mask, **kw).float().numpy()


def _jax(fn, q, k, v, kv_mask=None, dtype=jnp.float32, **kw):
    mask = None if kv_mask is None else jnp.asarray(kv_mask)
    out = fn(*(jnp.asarray(x).astype(dtype) for x in (q, k, v)), kv_mask=mask, **kw)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("gqa", [False, True])
def test_forward_matches_reference(causal, gqa):
    q, k, v = _make(Hkv=2 if gqa else 4)
    got = _port(q, k, v, causal=causal)
    np.testing.assert_allclose(got, _jax(FA, q, k, v, causal=causal), **FWD)
    np.testing.assert_allclose(got, _jax(attention_xla, q, k, v, causal=causal), **FWD)
    assert tf.launches["flash_attention_fwd"] == 0  # CPU tensors take the twin


def test_forward_kv_mask():
    q, k, v = _make()
    mask = _left_pad(2, 256, 64)
    got = _port(q, k, v, mask, causal=True)
    np.testing.assert_allclose(got, _jax(FA, q, k, v, mask, causal=True), **FWD)
    np.testing.assert_allclose(got, _jax(attention_xla, q, k, v, mask, causal=True), **FWD)


def test_fully_masked_rows_zero():
    q, k, v = _make(B=1, H=2, Hkv=2)
    mask = _left_pad(1, 256, 128)
    got = _port(q, k, v, mask, causal=True)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[0, :, :128], 0.0, atol=1e-6)
    np.testing.assert_allclose(got, _jax(FA, q, k, v, mask, causal=True), **FWD)


def test_decode_shape_end_aligned():
    q, k, v = _make(Sq=8, Skv=256)
    got = _port(q, k, v, causal=True)
    np.testing.assert_allclose(got, _jax(FA, q, k, v, causal=True), **FWD)
    np.testing.assert_allclose(got, _jax(attention_xla, q, k, v, causal=True), **FWD)


def test_unaligned_seq_lengths():
    q, k, v = _make(Sq=200, Skv=200)
    got = _port(q, k, v, causal=True)
    np.testing.assert_allclose(got, _jax(FA, q, k, v, causal=True), **FWD)
    np.testing.assert_allclose(got, _jax(attention_xla, q, k, v, causal=True), **FWD)


def test_explicit_causal_offset():
    q, k, v = _make(Sq=64, Skv=256)
    got = _port(q, k, v, causal=True, causal_offset=0)
    want = _jax(attention_xla, q, k, v, causal=True, causal_offset=0)
    np.testing.assert_allclose(got, want, **FWD)


def _port_grads(q, k, v, kv_mask=None, **kw):
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    mask = None if kv_mask is None else torch.from_numpy(kv_mask)
    (tf.flash_attention(*t, kv_mask=mask, **kw) ** 2).sum().backward()
    return [x.grad.numpy() for x in t]


def _jax_grads(fn, q, k, v, kv_mask=None, **kw):
    mask = None if kv_mask is None else jnp.asarray(kv_mask)

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v, kv_mask=mask, **kw) ** 2)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("gqa", [False, True])
def test_grads_match_reference(causal, gqa):
    q, k, v = _make(B=1, H=4, Hkv=2 if gqa else 4)
    got = _port_grads(q, k, v, causal=causal)
    for want in (_jax_grads(FA, q, k, v, causal=causal),
                 _jax_grads(attention_xla, q, k, v, causal=causal)):
        for a, b, name in zip(got, want, "qkv"):
            np.testing.assert_allclose(a, b, **GRAD, err_msg=f"d{name}")
    assert tf.launches["flash_attention_bwd_dq"] == tf.launches["flash_attention_bwd_dkv"] == 0


def test_grads_with_kv_mask():
    q, k, v = _make(B=2, H=2, Hkv=2)
    mask = _left_pad(2, 256, 32)
    got = _port_grads(q, k, v, mask, causal=True)
    want = _jax_grads(FA, q, k, v, mask, causal=True)
    for a, b, name in zip(got, want, "qkv"):
        assert np.isfinite(a).all(), f"d{name} has non-finite values"
        np.testing.assert_allclose(a, b, **GRAD, err_msg=f"d{name}")
    # masked kv positions receive exactly zero gradient
    assert not got[1][:, :, :32].any() and not got[2][:, :, :32].any()


def test_bfloat16_forward():
    q, k, v = _make()
    got = _port(q, k, v, dtype=torch.bfloat16, causal=True)
    want = _jax(attention_xla, q, k, v, dtype=jnp.bfloat16, causal=True)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
    t = torch.from_numpy(q).bfloat16()
    assert tf.flash_attention(t, t[:, :2], t[:, :2]).dtype == torch.bfloat16


@pytest.mark.parametrize("causal,Sq", [(True, 256), (False, 256), (True, 128)])
def test_lse_base2_matches_pallas_fwd(causal, Sq):
    """lse as K1 stores it: base 2, MASK_VALUE on a row with no valid key."""
    q, k, v = _make(B=2, H=4, Hkv=2, Sq=Sq, Skv=256, seed=3)
    mask = _left_pad(2, 256, 160)  # with Sq=128 end-aligned, early rows see no key
    offset = 256 - Sq
    o_j, lse_j = _fwd(*map(jnp.asarray, (q, k, v)), jnp.asarray(mask), causal, 64 ** -0.5,
                      offset, 128, 128, True)
    o_t, lse_t = tf.flash_attention_fwd_plain(*map(torch.from_numpy, (q, k, v)),
                                              torch.from_numpy(mask), causal=causal)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **FWD)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j)[..., 0], **FWD)
    if causal:
        assert (lse_t.numpy()[:, :, :160 - offset] == tf.MASK_VALUE).all()


@pytest.mark.parametrize("causal,Sq,gqa", [(True, 96, True), (False, 80, False), (True, 40, True)])
def test_bwd_twin_equals_autograd_of_fwd_twin(causal, Sq, gqa):
    q, k, v = _make(B=2, H=4, Hkv=2 if gqa else 4, Sq=Sq, Skv=96, D=64, seed=4)
    mask = _left_pad(2, 96, 24)
    mask[1, 60:70] = 0
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    mt = torch.from_numpy(mask)
    o, lse = tf.flash_attention_fwd_plain(qt, kt, vt, mt, causal=causal)
    do = torch.from_numpy(np.random.default_rng(5).normal(size=o.shape).astype(np.float32))
    want = torch.autograd.grad((o * do).sum(), (qt, kt, vt))
    got = tf.flash_attention_bwd_plain(qt.detach(), kt.detach(), vt.detach(), mt,
                                       o.detach(), lse.detach(), do, causal=causal)
    for a, b, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5,
                                   err_msg=f"d{name}")


def test_wrapper_rejects_bad_input():
    q, k, v = map(torch.from_numpy, _make(B=1, H=4, Hkv=2, Sq=8, Skv=8, D=64))
    with pytest.raises(ValueError, match="GQA"):
        tf.flash_attention(q, k[:, :1].expand(1, 3, 8, 64), v[:, :1].expand(1, 3, 8, 64))
    with pytest.raises(ValueError, match="dtype"):
        tf.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="kv_mask"):
        tf.flash_attention(q, k, v, kv_mask=torch.ones(1, 7))
    with pytest.raises(ValueError, match="scalar causal_offset"):
        tf.flash_attention(q, k, v, causal_offset=torch.zeros(1, dtype=torch.int32))


# The shapes the card tests (tests/test_torch_cuda.py) add for the bf16
# backward kernels' tiles: Sq and Skv of 1, 17, 64, 127, 129 and 1,000, GQA
# groups 1, 4 and 8, a 128-key tile entirely masked and the training layout
# at 1,024 rows. Here the twin the kernels are judged by is held against the
# JAX backward (interpret mode).
BWD_EDGE_CASES = [
    # B, H, Hkv, Sq, Skv, D, causal, causal_offset, mask
    (1, 4, 4, 1, 1, 128, True, None, None),
    (1, 8, 2, 1, 1000, 64, False, None, "right"),
    (2, 8, 1, 17, 17, 128, True, None, None),
    (1, 8, 2, 17, 1000, 64, True, None, "tail"),
    (1, 4, 1, 64, 127, 128, True, None, "holes"),
    (1, 8, 8, 127, 129, 64, False, None, None),
    (2, 8, 1, 129, 64, 128, True, 0, None),
    (1, 16, 4, 1000, 1000, 128, True, None, "right"),
    (1, 4, 1, 300, 520, 128, True, None, "tile"),
    (1, 32, 8, 1024, 1024, 128, True, None, "tail"),
]


def _edge_mask(B, Skv, mask):
    if mask is None:
        return None
    kv_mask = np.ones((B, Skv), dtype=np.int32)
    if mask == "right":
        kv_mask[:, Skv - 37:] = 0
    elif mask == "tail":  # right padding from 27/32 of the keys on
        kv_mask[:, Skv * 27 // 32:] = 0
    elif mask == "tile":
        kv_mask[:, 128:256] = 0
    else:  # holes
        kv_mask[:, 3:9] = 0
        kv_mask[:, 70:] = 0
    return kv_mask


@pytest.mark.parametrize("case", BWD_EDGE_CASES)
def test_grads_at_backward_tile_edges(case):
    B, H, Hkv, Sq, Skv, D, causal, off, mask = case
    q, k, v = _make(B=B, H=H, Hkv=Hkv, Sq=Sq, Skv=Skv, D=D, seed=Sq + Skv)
    kv_mask = _edge_mask(B, Skv, mask)
    got = _port_grads(q, k, v, kv_mask, causal=causal, causal_offset=off)
    want = _jax_grads(FA, q, k, v, kv_mask, causal=causal, causal_offset=off)
    for a, b, name in zip(got, want, "qkv"):
        assert np.isfinite(a).all(), f"d{name} has non-finite values"
        np.testing.assert_allclose(a, b, **GRAD, err_msg=f"d{name}")
    if kv_mask is not None:  # masked keys get exactly zero dk and dv
        dead = kv_mask == 0
        assert not got[1][:, :, dead[0]].any() and not got[2][:, :, dead[0]].any()
