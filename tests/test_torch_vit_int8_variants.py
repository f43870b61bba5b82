"""Port parity: the fused W8A8 tower under every calibration shape and
epilogue against the JAX package on the CPU: K7b ``qkv_int8``, K7c with a
float o, K7g's row-max, static-stabiliser and float-output consume paths,
K7f ``mlp_fused``, K10 ``encoder_attention_int8``, the (L, 4) and (L, 7)
towers, ``int8_o=False`` and ``fuse_l=False``, their trees through
``load_jax_params``, and the engine serving an (L, 4) tower.

The JAX Pallas kernels run in interpret mode, as tests/test_vit_int8_fused.py
runs them; the port's wrappers run their plain twins (CPU tensors). Inputs
come from numpy seeds and reach both sides as the same values.

Tolerances (tests/test_torch_vit_int8.py's, and two more):
- int8 outputs: equal on >= 99.5% of elements, never more than 1 apart;
- residual and projection outputs: within one ulp of their dtype at their
  magnitude (the twins round where XLA rounds);
- float attention outputs (K7g's float forms, K10 in float32): within two
  ulps of their dtype at the magnitude of the tensor's largest value. The
  P.V product sums up to S terms of both signs in another order than XLA's
  dot, so its rounding error sits at the scale of the terms, not of an
  output that cancellation made small; the f32 denominator is one more sum
  in another order;
- K10's p codes round(p * 127) may land one apart from the reference's,
  because ``torch.exp`` is not XLA's ``exp``: one such key moves an output
  by at most |v8| pv_scale / l <= s_v (l >= 1, the row's maximum key gives
  p = 1). The test holds the outputs within s_v, and 99% of them within the
  two-ulp bound above;
- whole towers: cosine >= 0.9999 against JAX on the same tree, and the JAX
  package's own contracts (tests/test_vit_int8_fused.py) on the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimeditron_torch.convert import export_jax_params, load_jax_params
from multimeditron_torch.models import multimodal as tm
from multimeditron_torch.models import vit_quant as tq
from multimeditron_torch.modalities.image_clip import ImageConfig as TImageConfig
from multimeditron_torch.modalities.image_clip import ImageModality as TImageModality
from multimeditron_torch.ops import encoder_attention as tenc
from multimeditron_torch.ops import vit_int8_fused as tf
from multimeditron_tpu.models import vit_quant as jq
from multimeditron_tpu.models.multimodal import MultimodalModel
from multimeditron_tpu.models.vit import init_vit_params, vit_forward
from multimeditron_tpu.ops import encoder_attention as jenc
from multimeditron_tpu.ops import vit_int8_fused as jf
from multimeditron_tpu.serve.engine import EngineConfig as JEngineConfig
from multimeditron_tpu.serve.engine import ServingEngine as JServingEngine
from tests.test_multimodal import tiny_mm_config
from tests.test_torch_vit import perturbed
from tests.test_torch_vit_int8 import (
    DTYPES,
    _assert_int8_close,
    _assert_within_ulp,
    _cosine,
    _modality_case,
    _np,
    _pair,
    _pixels,
    _port_cfg,
    _port_tree,
    _qkv_case,
    _small_cfg,
)


def _assert_attention_close(got: torch.Tensor, want, dtype: torch.dtype, share: float = 1.0):
    """Within two ulps of ``dtype`` at the magnitude of the largest |want|,
    on at least ``share`` of the elements."""
    assert got.dtype == dtype
    w = np.asarray(want, np.float32)
    top = np.abs(w).max()
    bound = 2 * np.exp2(np.floor(np.log2(top))) * float(torch.finfo(dtype).eps)
    assert (np.abs(got.float().numpy() - w) <= bound).mean() >= share


# ----------------------------------------------------------------------
# K7b, K7c with a float o
# ----------------------------------------------------------------------
def _k7b_case(seed, M, K, D):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (M, K)).astype(np.int8)
    wq = rng.integers(-127, 128, (3, K, D)).astype(np.int8)  # JAX (3, K, N)
    ws = (rng.uniform(0.5, 1.5, (3, 1, D)) / (127 * 60 * K ** 0.5)).astype(np.float32)
    bias = (rng.normal(size=(3, 1, D)) * 0.1).astype(np.float32)
    return xq, wq, ws, bias


@pytest.mark.parametrize("out", ["float32", "bfloat16", "int8"])
def test_qkv_int8_matches_pallas(out):
    xq, wq, ws, bias = _k7b_case(1, 40, 128, 128)
    scales = [0.02, 0.03, 0.025]
    kw_j = (dict(qkv_scales=jnp.asarray(scales)) if out == "int8"
            else dict(out_dtype=DTYPES[out][0]))
    kw_t = dict(qkv_scales=scales) if out == "int8" else dict(out_dtype=DTYPES[out][1])
    want = jf.qkv_int8(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(ws), jnp.asarray(bias),
                       1.3, block_rows=8, **kw_j)
    got = tf.qkv_int8(torch.from_numpy(xq), torch.from_numpy(wq.swapaxes(1, 2).copy()),
                      torch.from_numpy(ws), torch.from_numpy(bias), 1.3, **kw_t)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == (40, 128)
        if out == "int8":
            _assert_int8_close(g, w)
            assert np.abs(np.asarray(w)).mean() > 5
        else:
            _assert_within_ulp(g, np.asarray(w, np.float32), DTYPES[out][1])


# at the row edges of the card's 128-row projection tiles, widths 128 and 256
@pytest.mark.parametrize("out", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("M", [127, 128, 129])
def test_qkv_int8_matches_pallas_at_tile_edges(out, D, M):
    xq, wq, ws, bias = _k7b_case(9, M, D, D)
    scales = [0.02, 0.03, 0.025]
    kw_j = (dict(qkv_scales=jnp.asarray(scales)) if out == "int8"
            else dict(out_dtype=DTYPES[out][0]))
    kw_t = dict(qkv_scales=scales) if out == "int8" else dict(out_dtype=DTYPES[out][1])
    want = jf.qkv_int8(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(ws), jnp.asarray(bias),
                       1.3, **kw_j)
    got = tf.qkv_int8(torch.from_numpy(xq), torch.from_numpy(wq.swapaxes(1, 2).copy()),
                      torch.from_numpy(ws), torch.from_numpy(bias), 1.3, **kw_t)
    for g, w in zip(got, want):
        assert g.shape == (M, D)
        if out == "int8":
            _assert_int8_close(g, w)
        else:
            _assert_within_ulp(g, np.asarray(w, np.float32), DTYPES[out][1])


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_oproj_ln_quant_float_o_matches_pallas(dtype):
    rng = np.random.default_rng(2)
    M, D = 48, 128
    o = (rng.normal(size=(M, D)) * 0.5).astype(np.float32)
    x_res = rng.normal(size=(M, D)).astype(np.float32)
    w8 = rng.integers(-127, 128, (D, D)).astype(np.int8)
    ws = (rng.uniform(0.5, 1.5, D) / (127 * 60 * D ** 0.5)).astype(np.float32)
    bias = (rng.normal(size=D) * 0.1).astype(np.float32)
    lnw = rng.uniform(0.5, 1.5, D).astype(np.float32)
    lnb = (rng.normal(size=D) * 0.1).astype(np.float32)
    (jo, to), (jres, tres) = _pair(o, dtype), _pair(x_res, dtype)
    s1 = 1.5 / 127
    jx, jxq = jf.oproj_ln_quant(jo, jres, jnp.asarray(w8), jnp.asarray(ws), jnp.asarray(bias),
                                jnp.asarray(lnw), jnp.asarray(lnb), s1, 0.025, 1e-5,
                                block_rows=16)
    tx, txq = tf.oproj_ln_quant(to, tres, torch.from_numpy(w8.T.copy()), torch.from_numpy(ws),
                                torch.from_numpy(bias), torch.from_numpy(lnw),
                                torch.from_numpy(lnb), s1, 0.025, 1e-5)
    _assert_within_ulp(tx, np.asarray(jx, np.float32), DTYPES[dtype][1])
    _assert_int8_close(txq, jxq)
    assert np.abs(np.asarray(jxq)).mean() > 5


# ----------------------------------------------------------------------
# K7g's other consume paths
# ----------------------------------------------------------------------
FORMS = {  # port kwargs, JAX kwargs
    "rowmax": (dict(static_smax=False), dict(static_smax=False, allow_packed=False)),
    "static": (dict(static_smax=True, fuse_l=False),
               dict(static_smax=True, fuse_l=False, allow_packed=False)),
    "fused_float": (dict(static_smax=True, fuse_l=True),
                    dict(static_smax=True, fuse_l=True, allow_packed=False)),
}


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S,kv_len", [(17, 17), (24, 24), (24, 20)])
def test_qkv_attn_int8_consume_paths_match_pallas(form, dtype, S, kv_len):
    B, D, H = 2, 128, 4
    xq, wq, ws, bias, s6 = _qkv_case(3, B, S, D, 6.0)
    tkw, jkw = FORMS[form]
    want = jf.qkv_attn_int8(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(ws),
                            jnp.asarray(bias), jnp.asarray(s6).reshape(6, 1), H, kv_len,
                            out_dtype=DTYPES[dtype][0], block_imgs=2, **jkw)
    got = tf.qkv_attn_int8(torch.from_numpy(xq), torch.from_numpy(wq.swapaxes(1, 2).copy()),
                           torch.from_numpy(ws), torch.from_numpy(bias), s6.tolist(), H, kv_len,
                           out_dtype=DTYPES[dtype][1], **tkw)
    want = np.asarray(want, np.float32)[:, :kv_len]
    _assert_attention_close(got[:, :kv_len], want, DTYPES[dtype][1])
    assert np.abs(want).mean() > 0.05


def test_int8_output_without_fuse_l_raises():
    xq, wq, ws, bias, s6 = _qkv_case(4, 1, 8, 128, 6.0)
    with pytest.raises(ValueError, match="fuse_l"):
        jf.qkv_attn_int8(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(ws), jnp.asarray(bias),
                         jnp.asarray(s6).reshape(6, 1), 4, 8, out_dtype=jnp.int8,
                         static_smax=True, fuse_l=False, allow_packed=False)
    with pytest.raises(ValueError, match="fuse_l"):
        tf.qkv_attn_int8(torch.from_numpy(xq), torch.from_numpy(wq.swapaxes(1, 2).copy()),
                         torch.from_numpy(ws), torch.from_numpy(bias), s6.tolist(), 4, 8,
                         fuse_l=False)


# ----------------------------------------------------------------------
# K7f, K10
# ----------------------------------------------------------------------
def _mlp_case(seed, M, D, F):
    # tests/test_vit_int8_fused.py:151's inputs
    rng = np.random.default_rng(seed)
    w1 = rng.integers(-127, 128, (D, F), np.int8)
    w1_s = rng.uniform(0.001, 0.01, (F,)).astype(np.float32)
    b1 = (rng.normal(size=(F,)) * 0.01).astype(np.float32)
    w2 = rng.integers(-127, 128, (F, D), np.int8)
    w2_s = rng.uniform(0.001, 0.01, (D,)).astype(np.float32)
    b2 = (rng.normal(size=(D,)) * 0.01).astype(np.float32)
    lnw = (rng.normal(size=(D,)) * 0.1 + 1.0).astype(np.float32)
    lnb = (rng.normal(size=(D,)) * 0.01).astype(np.float32)
    xq = rng.integers(-127, 128, (M, D), np.int8)
    xres = (rng.normal(size=(M, D)) * 0.1).astype(np.float32)
    return xq, xres, w1, w1_s, b1, w2, w2_s, b2, lnw, lnb


@pytest.mark.parametrize("act", ["quick_gelu", "gelu_pytorch_tanh", "gelu"])
def test_mlp_fused_matches_pallas_and_split_pair(act):
    M, D, F = 16, 128, 256
    xq, xres, w1, w1_s, b1, w2, w2_s, b2, lnw, lnb = _mlp_case(3, M, D, F)
    scal = (0.04, 0.05, 0.06, 1e-5)
    jx, jxq = jf.mlp_fused(*map(jnp.asarray, (xq,)), jnp.asarray(xres, jnp.bfloat16),
                           *map(jnp.asarray, (w1, w1_s, b1, w2, w2_s, b2, lnw, lnb)), *scal, act,
                           block_rows=8, block_cols=F // 2)
    targs = (torch.from_numpy(xq), torch.from_numpy(xres).bfloat16(),
             torch.from_numpy(w1.T.copy()), torch.from_numpy(w1_s), torch.from_numpy(b1),
             torch.from_numpy(w2.T.copy()), torch.from_numpy(w2_s), torch.from_numpy(b2),
             torch.from_numpy(lnw), torch.from_numpy(lnb))
    tx, txq = tf.mlp_fused(*targs, *scal, act)
    _assert_within_ulp(tx, np.asarray(jx, np.float32), torch.bfloat16)
    _assert_int8_close(txq, jxq)
    assert np.abs(np.asarray(jxq)).mean() > 5
    # JAX's own contract (:151-187): bit for bit the split pair
    hq = tf.fc1_gelu_quant(targs[0], *targs[2:5], 0.04, 0.05, act)
    sx, sxq = tf.fc2_res_ln_quant(hq, targs[1], *targs[5:10], 0.05, 0.06, 1e-5)
    assert torch.equal(txq, sxq) and torch.equal(tx, sx)


def test_mlp_fused_refuses_the_approximate_sigmoid():
    args = _mlp_case(4, 8, 128, 256)
    with pytest.raises(ValueError, match="quick_gelu_approx"):
        jf.mlp_fused(*map(jnp.asarray, args), 0.04, 0.05, 0.06, 1e-5, "quick_gelu_approx",
                     block_rows=8, block_cols=128)
    targs = [torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2 and i in (2, 5) else a))
             for i, a in enumerate(args)]
    with pytest.raises(ValueError, match="quick_gelu_approx"):
        tf.mlp_fused(*targs, 0.04, 0.05, 0.06, 1e-5, "quick_gelu_approx")


def _int8_qkv(seed, B, S, D):
    # tests/test_vit_int8_fused.py:106's inputs
    rng = np.random.default_rng(seed)
    f = [rng.normal(size=(B, S, D)) * 0.4 for _ in range(3)]
    scales = [np.abs(a).max() / 127.0 for a in f]
    return [np.round(a / s).astype(np.int8) for a, s in zip(f, scales)], scales


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("S,kv_len", [(24, 20), (17, 17)])
def test_encoder_attention_int8_matches_pallas(dtype, S, kv_len):
    B, D, H = 2, 64, 4
    (q8, k8, v8), (sq, sk, sv) = _int8_qkv(0, B, S, D)
    qk, pv = sq * sk * (D // H) ** -0.5, sv / 127.0
    want = jenc.encoder_attention_int8(jnp.asarray(q8), jnp.asarray(k8), jnp.asarray(v8), H,
                                       qk_scale=qk, pv_scale=pv, kv_len=kv_len,
                                       out_dtype=DTYPES[dtype][0])
    got = tenc.encoder_attention_int8(*map(torch.from_numpy, (q8, k8, v8)), H, qk, pv, kv_len,
                                      out_dtype=DTYPES[dtype][1])
    want = np.asarray(want, np.float32)[:, :kv_len]
    got = got[:, :kv_len]
    assert np.abs(got.float().numpy() - want).max() <= sv
    _assert_attention_close(got, want, DTYPES[dtype][1], share=0.99)
    # and the JAX test's own bound against float attention (:106-128)
    ref = jenc.encoder_attention(*(jnp.asarray(a.astype(np.float32) * s)
                                   for a, s in ((q8, sq), (k8, sk), (v8, sv))), H, kv_len=kv_len)
    assert _cosine(_np(got), np.asarray(ref, np.float32)[:, :kv_len]) > 0.999


# ----------------------------------------------------------------------
# Host scalars and whole towers
# ----------------------------------------------------------------------
@pytest.mark.parametrize("cols", [4, 7, 8])
@pytest.mark.parametrize("int8_o", [True, False])
def test_layer_scalars_follow_the_jax_host_arithmetic(cols, int8_o):
    rng = np.random.default_rng(cols)
    sc = np.concatenate([rng.uniform(0.005, 0.05, (3, min(cols, 7))),
                         rng.uniform(5.0, 9.0, (3, max(cols - 7, 0)))], axis=1).astype(np.float32)
    cfg = _port_cfg(_small_cfg("float32"))
    got = tf.layer_scalars(torch.from_numpy(sc), cfg, int8_o)
    assert [r["merged"] for r in got] == [cols >= 7] * 3
    assert [r["static_smax"] for r in got] == [cols >= 8] * 3
    # vit_forward_int8_fused's own arithmetic (:1126-1130, :1162-1172)
    a = jnp.asarray(sc)
    if cols < 8:
        a = jnp.concatenate([a, jnp.zeros((3, 1), a.dtype)], axis=1)
    sm = (cfg.hidden_size // cfg.num_heads) ** -0.5
    for i, r in enumerate(got):
        assert (r["s0"], r["s1"], r["s2"], r["s3"]) == tuple(float(x) for x in sc[i, :4])
        assert r["s0_next"] == float(sc[(i + 1) % 3, 0])
        if cols < 7:
            assert r["scales6"] is None
            continue
        s = a[i]
        row5 = (1.0 / s[1]) if int8_o else (s[6] / 127.0)
        want = jnp.stack([s[0], 1.0 / s[4], 1.0 / s[5], s[7] * 1.4426950408889634,
                          s[4] * s[5] * sm, row5])
        assert r["scales6"] == tuple(float(x) for x in np.asarray(want))
    with pytest.raises(ValueError, match="expected"):
        tf.layer_scalars(torch.ones(3, 5), cfg)


VARIANTS = {  # calibration columns, forward flags
    "L4": (4, {}), "L7": (7, {}), "L8_float_out": (8, dict(int8_o=False)),
    "L8_no_fuse_l": (8, dict(fuse_l=False)),
}


@pytest.fixture(scope="module", params=list(DTYPES))
def small_tower(request):
    jcfg = _small_cfg(request.param)
    params = init_vit_params(jax.random.PRNGKey(0), jcfg)
    pixels = _pixels(1, 4)
    return request.param, jcfg, params, _port_tree(jcfg, params), pixels


def _scales(jcfg, params, pixels, cols):
    if cols == 4:
        return jq.calibrate_act_scales(params, jcfg, jnp.asarray(pixels))
    return jf.calibrate_vit_int8_fused(params, jcfg, jnp.asarray(pixels))[:, :cols]


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_fused_tower_variants_match_jax(small_tower, variant):
    dtype, jcfg, params, tree, pixels = small_tower
    cols, kw = VARIANTS[variant]
    jscales = _scales(jcfg, params, pixels, cols)
    want = jf.vit_forward_int8_fused(jf.pack_vit_int8_fused(params), jcfg, jnp.asarray(pixels),
                                     jscales, **kw)
    got = tf.vit_forward_int8_fused(tf.pack_vit_int8_fused(tree), _port_cfg(jcfg),
                                    torch.from_numpy(pixels), torch.tensor(np.asarray(jscales)),
                                    **kw)
    assert got.shape == want.shape and got.dtype == DTYPES[dtype][1]
    assert _cosine(_np(got), want) >= 0.9999
    # the JAX contract against the float tower (:68-73, :89-103)
    assert _cosine(_np(got), vit_forward(params, jcfg, jnp.asarray(pixels))) > 0.999


def test_l4_fused_tower_matches_unfused_int8(small_tower):
    """JAX's :53-66 on the port: the (L, 4) fused tower against the unfused
    int8 tower with the same scales."""
    dtype, jcfg, params, tree, pixels = small_tower
    cfg = _port_cfg(jcfg)
    scales = tq.calibrate_act_scales(tree, cfg, torch.from_numpy(pixels))
    ref = tq.vit_forward_int8(tq.quantize_vit_params(tree), cfg, torch.from_numpy(pixels),
                              act_scales=scales)
    out = tf.vit_forward_int8_fused(tf.pack_vit_int8_fused(tree), cfg, torch.from_numpy(pixels),
                                    scales)
    assert out.shape == ref.shape
    assert _cosine(_np(out), _np(ref)) > 0.9995
    np.testing.assert_allclose(_np(out), _np(ref), atol=0.15, rtol=0.1)


def test_l7_fused_tower_matches_l8(small_tower):
    """JAX's :89-104 (and :228-231) on the port: the row-max (L, 7) tower
    against the static-stabiliser (L, 8) one, both against the float tower."""
    dtype, jcfg, params, tree, pixels = small_tower
    cfg = _port_cfg(jcfg)
    scales8 = tf.calibrate_vit_int8_fused(tree, cfg, torch.from_numpy(pixels))
    packed = tf.pack_vit_int8_fused(tree)
    out8 = tf.vit_forward_int8_fused(packed, cfg, torch.from_numpy(pixels), scales8)
    out7 = tf.vit_forward_int8_fused(packed, cfg, torch.from_numpy(pixels), scales8[:, :7])
    ref = vit_forward(params, jcfg, jnp.asarray(pixels))
    assert _cosine(_np(out7), ref) > 0.999 and _cosine(_np(out8), ref) > 0.999
    assert _cosine(_np(out7), _np(out8)) > 0.9995


def test_l4_fused_no_cls_variant():
    """JAX's :131 on the port: a SigLIP-style tower with (L, 4) scales,
    against JAX's fused tower and the unfused int8 tower."""
    jcfg = _small_cfg("bfloat16", num_layers=2, use_cls_token=False, use_pre_layernorm=False,
                      post_layernorm_output=True, patch_bias=True,
                      hidden_act="gelu_pytorch_tanh")
    params = perturbed(init_vit_params(jax.random.PRNGKey(2), jcfg), seed=3, scale=0.02)
    pixels = _pixels(3, 2)
    tree, cfg = _port_tree(jcfg, params), _port_cfg(jcfg)
    jscales = jq.calibrate_act_scales(params, jcfg, jnp.asarray(pixels))
    want = jf.vit_forward_int8_fused(jf.pack_vit_int8_fused(params), jcfg, jnp.asarray(pixels),
                                     jscales)
    scales = torch.tensor(np.asarray(jscales))
    got = tf.vit_forward_int8_fused(tf.pack_vit_int8_fused(tree), cfg, torch.from_numpy(pixels),
                                    scales)
    assert got.shape == want.shape == (2, 4, 128)
    assert _cosine(_np(got), want) >= 0.9999
    ref = tq.vit_forward_int8(tq.quantize_vit_params(tree), cfg, torch.from_numpy(pixels),
                              act_scales=scales)
    assert _cosine(_np(got), _np(ref)) > 0.9995


# ----------------------------------------------------------------------
# Trees through convert, and serving
# ----------------------------------------------------------------------
def _fused_tree(jmod, params, values, cols):
    """JAX's fused tree with its calibration cut to ``cols`` columns ((L, 4):
    the same four scales calibrate_act_scales computes)."""
    qparams = jmod.quantize_params(params, calibration_values=values, fused=True)
    return {**qparams, "act_scales": qparams["act_scales"][:, :cols]}


@pytest.mark.parametrize("tower_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cols", [4, 7])
def test_convert_round_trip_and_encode(cols, tower_dtype):
    """A JAX fused tree loads and encodes as JAX does; the port's export of
    it (bf16 leaves written as float32) loads back to the same tower: the
    leaves carried over from the float tower keep the tower's dtype."""
    jmod, params, tmod, values = _modality_case("uint8", tower_dtype)
    qparams = jax.tree.map(np.asarray, _fused_tree(jmod, params, values, cols))
    want = jmod.encode(qparams, jnp.asarray(values))
    load_jax_params(tmod, qparams)
    assert isinstance(tmod.embedder_q, tf.ViTInt8Fused)
    assert tmod.embedder_q.act_scales.shape[1] == cols
    # the kernels take contiguous tensors: the (K, N) -> (N, K) swap is copied
    assert all(t.is_contiguous() for t in tmod.embedder_q.tree().values())
    with torch.no_grad():
        got = tmod.encode(torch.from_numpy(values))
    assert _cosine(_np(got), want) >= 0.9999
    back = export_jax_params(tmod)
    assert jax.tree.structure(back) == jax.tree.structure(qparams)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(qparams)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b if b.dtype == np.int8 else b.astype(np.float32))
    other = TImageModality(TImageConfig(**dataclasses.asdict(tmod.config)), device="cpu")
    load_jax_params(other, back)
    with torch.no_grad():
        assert torch.equal(other.encode(torch.from_numpy(values)), got)


def test_convert_round_trip_keeps_an_unfused_bf16_tower():
    jmod, params, tmod, values = _modality_case("uint8", "bfloat16")
    qparams = jax.tree.map(np.asarray, jmod.quantize_params(params, calibration_values=values))
    load_jax_params(tmod, qparams)
    other = TImageModality(TImageConfig(**dataclasses.asdict(tmod.config)), device="cpu")
    load_jax_params(other, export_jax_params(tmod))
    with torch.no_grad():
        got = other.encode(torch.from_numpy(values))
        assert got.dtype == torch.bfloat16
        assert torch.equal(got, tmod.encode(torch.from_numpy(values)))


def test_engine_serves_an_l4_tower_with_jax_tokens():
    """The tiny paged engine with an (L, 4) fused image tower gives the JAX
    engine's greedy tokens."""
    from tests.test_torch_engine import BASE, _engine
    from multimeditron_tpu.data.chat_template import ChatTemplate
    from multimeditron_tpu.data.collator import DataCollatorForMultimodal
    from multimeditron_tpu.data.loaders import AutoModalityLoader
    from tests.fixtures.toy_tokenizer import ToyTokenizer
    from tests.test_multimodal import ATTACH
    from tests.test_paged_engine import PROMPTS

    jmodel = MultimodalModel(tiny_mm_config())
    jmodel.config.eos_token_idx = 2
    params = jmodel.init_params(jax.random.PRNGKey(0))
    img = jmodel.modalities["image"]
    calib = np.random.default_rng(5).integers(0, 256, (4, 16, 16, 3)).astype(np.uint8)
    params["modalities"]["image"] = _fused_tree(img, params["modalities"]["image"], calib, 4)
    collator = DataCollatorForMultimodal(
        tokenizer=ToyTokenizer(), modality_processors=jmodel.processors(),
        modality_loaders={"image": AutoModalityLoader.create("raw-image")},
        attachment_token=ATTACH, chat_template=ChatTemplate.llama(),
        add_generation_prompt=True, pad_to_multiple=8)
    batches = [collator([p]) for p in PROMPTS]
    want = JServingEngine(jmodel, params, JEngineConfig(**BASE)).generate(batches)
    tmodel = tm.MultimodalModel(tm.MultimodalConfig.from_dict(jmodel.config.to_dict()),
                                device="cpu")
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    tower = tmodel.modalities["image"].embedder_q
    assert isinstance(tower, tf.ViTInt8Fused) and not tower.scalars[0]["merged"]
    assert _engine(tmodel).generate(batches) == want
