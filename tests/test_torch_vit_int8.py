"""Port parity: the W8A8 image tower (fused kernels K7a/K7c/K7d/K7e/K7g with
(L, 8) calibrations, their host side, the unfused int8 tower, the int8
projector and the image modality's ``quantize_params``) against the JAX
package on the CPU. The other calibrations and epilogues, K7b, K7f and K10
are in tests/test_torch_vit_int8_variants.py.

The JAX Pallas kernels run in interpret mode, as tests/test_vit_int8_fused.py
runs them; the port's wrappers run their plain twins (CPU tensors). Inputs
come from numpy seeds and reach both sides as the same values.

Tolerances:
- int8 kernel outputs: equal on >= 99.5% of elements, never more than 1
  apart (LayerNorm and softmax sums are taken in another order, which can
  move a value across a rounding boundary);
- residual outputs: within one ulp of their dtype at their magnitude (the
  twins round where XLA rounds, including its fused multiply-adds);
- packed int8 weights: bitwise; calibration and smoothing: 1e-4 relative
  (float32);
- whole towers: cosine >= 0.9999 against JAX on the same tree, and the JAX
  package's own contracts against the float tower.
"""

import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimeditron_torch.convert import export_jax_params, load_jax_params
from multimeditron_torch.modalities.image_clip import ImageConfig as TImageConfig
from multimeditron_torch.modalities.image_clip import ImageModality as TImageModality
from multimeditron_torch.models import projector as tproj
from multimeditron_torch.models import vit_quant as tq
from multimeditron_torch.models.vit import ViT, ViTConfig
from multimeditron_torch.ops import vit_int8_fused as tf
from multimeditron_tpu.modalities.image_clip import ImageModality as JImageModality
from multimeditron_tpu.models import projector as jproj
from multimeditron_tpu.models import vit_quant as jq
from multimeditron_tpu.models.vit import ViTConfig as JViTConfig
from multimeditron_tpu.models.vit import init_vit_params, vit_forward
from multimeditron_tpu.ops import vit_int8_fused as jf
from tests.test_multimodal import tiny_image_config
from tests.test_torch_vit import perturbed

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _cosine(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def _np(x):
    return np.asarray(x.float() if torch.is_tensor(x) else np.asarray(x, np.float32))


def _assert_int8_close(got, want):
    got, want = np.asarray(got).astype(np.int32), np.asarray(want).astype(np.int32)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.995


def _assert_within_ulp(got: torch.Tensor, want, dtype: torch.dtype):
    assert got.dtype == dtype
    w = np.asarray(want, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30)))) * float(torch.finfo(dtype).eps)
    assert (np.abs(got.float().numpy() - w) <= ulp).all()


def _pair(arr: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(arr, jd), torch.from_numpy(arr).to(td)


def _port_cfg(jcfg) -> ViTConfig:
    return ViTConfig(**{**dataclasses.asdict(jcfg),
                        "dtype": getattr(torch, jnp.dtype(jcfg.dtype).name)})


def _port_tree(jcfg, params):
    vit = ViT(_port_cfg(jcfg), device="cpu")
    load_jax_params(vit, jax.tree.map(np.asarray, params))
    return tq.vit_params_tree(vit)


def _small_cfg(dtype, **kw):
    # tests/test_vit_int8_fused.py's small tower
    base = dict(image_size=28, patch_size=14, hidden_size=128, num_layers=3, num_heads=4,
                intermediate_size=256, dtype=DTYPES[dtype][0])
    return JViTConfig(**{**base, **kw})


def _pixels(seed, n, size=28):
    return np.random.default_rng(seed).uniform(-1.5, 1.5, (n, size, size, 3)).astype(np.float32)


# ----------------------------------------------------------------------
# Each kernel's twin against the Pallas kernel, same int8 inputs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ln_quant_matches_pallas(dtype):
    rng = np.random.default_rng(0)
    M, D = 40, 128
    x = (rng.normal(size=(M, D)) * 2 + 0.3).astype(np.float32)
    w = rng.uniform(0.5, 1.5, D).astype(np.float32)
    b = (rng.normal(size=D) * 0.1).astype(np.float32)
    jx, tx = _pair(x, dtype)
    want = jf.ln_quant(jx, jnp.asarray(w), jnp.asarray(b), 0.03, 1e-5)
    got = tf.ln_quant(tx, torch.from_numpy(w), torch.from_numpy(b), 0.03, 1e-5)
    _assert_int8_close(got, want)


def _gemm_case(seed, M, K, N, act_scale):
    rng = np.random.default_rng(seed)
    a8 = rng.integers(-127, 128, (M, K)).astype(np.int8)
    w8 = rng.integers(-127, 128, (K, N)).astype(np.int8)  # JAX layout (K, N)
    ws = (rng.uniform(0.5, 1.5, N) / (127 * act_scale * K ** 0.5)).astype(np.float32)
    bias = (rng.normal(size=N) * 0.1).astype(np.float32)
    return rng, a8, w8, ws, bias


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name,K", [("oproj_ln_quant", 128), ("fc2_res_ln_quant", 256)])
def test_res_ln_quant_matches_pallas(dtype, name, K):
    M, D = 48, 128
    rng, a8, w8, ws, bias = _gemm_case(1, M, K, D, 60)
    x_res = rng.normal(size=(M, D)).astype(np.float32)
    lnw = rng.uniform(0.5, 1.5, D).astype(np.float32)
    lnb = (rng.normal(size=D) * 0.1).astype(np.float32)
    jres, tres = _pair(x_res, dtype)
    jfn, tfn = getattr(jf, name), getattr(tf, name)
    jx, jxq = jfn(jnp.asarray(a8), jres, jnp.asarray(w8), jnp.asarray(ws), jnp.asarray(bias),
                  jnp.asarray(lnw), jnp.asarray(lnb), 1.3, 0.025, 1e-5, block_rows=16)
    tx, txq = tfn(torch.from_numpy(a8), tres, torch.from_numpy(w8.T.copy()),
                  torch.from_numpy(ws), torch.from_numpy(bias), torch.from_numpy(lnw),
                  torch.from_numpy(lnb), 1.3, 0.025, 1e-5)
    _assert_within_ulp(tx, np.asarray(jx, np.float32), DTYPES[dtype][1])
    _assert_int8_close(txq, jxq)


@pytest.mark.parametrize("act", ["quick_gelu_approx", "quick_gelu", "gelu_pytorch_tanh",
                                 "gelu_new", "gelu"])
def test_fc1_gelu_quant_matches_pallas(act):
    M, K, N = 32, 128, 256
    _, a8, w8, ws, bias = _gemm_case(2, M, K, N, 40)
    want = jf.fc1_gelu_quant(jnp.asarray(a8), jnp.asarray(w8), jnp.asarray(ws),
                             jnp.asarray(bias), 1.1, 0.04, act, block_rows=8)
    got = tf.fc1_gelu_quant(torch.from_numpy(a8), torch.from_numpy(w8.T.copy()),
                            torch.from_numpy(ws), torch.from_numpy(bias), 1.1, 0.04, act)
    _assert_int8_close(got, want)
    assert np.abs(np.asarray(want)).mean() > 5  # the case exercises the quantiser


# The twins that the card holds K7d and K7e to, at the edges of the CUDA
# kernels' tiles (64-row warpgroup tiles, 128-row blocks; three 128-column
# weight tiles; D = 768, a cluster of three 256-column blocks; K = 192, 128
# bytes of K a stage and then 64)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("M", [63, 64, 65, 129])
def test_fc2_res_ln_quant_matches_pallas_at_tile_edges(dtype, M):
    K, D = 192, 768
    rng, a8, w8, ws, bias = _gemm_case(4, M, K, D, 60)
    x_res = rng.normal(size=(M, D)).astype(np.float32)
    lnw = rng.uniform(0.5, 1.5, D).astype(np.float32)
    lnb = (rng.normal(size=D) * 0.1).astype(np.float32)
    jres, tres = _pair(x_res, dtype)
    jx, jxq = jf.fc2_res_ln_quant(jnp.asarray(a8), jres, jnp.asarray(w8), jnp.asarray(ws),
                                  jnp.asarray(bias), jnp.asarray(lnw), jnp.asarray(lnb), 1.3,
                                  0.025, 1e-5)
    tx, txq = tf.fc2_res_ln_quant(torch.from_numpy(a8), tres, torch.from_numpy(w8.T.copy()),
                                  torch.from_numpy(ws), torch.from_numpy(bias),
                                  torch.from_numpy(lnw), torch.from_numpy(lnb), 1.3, 0.025, 1e-5)
    _assert_within_ulp(tx, np.asarray(jx, np.float32), DTYPES[dtype][1])
    _assert_int8_close(txq, jxq)


@pytest.mark.parametrize("act", ["quick_gelu_approx", "gelu"])
@pytest.mark.parametrize("M", [63, 64, 65, 129])
def test_fc1_gelu_quant_matches_pallas_at_tile_edges(act, M):
    K, N = 192, 384
    _, a8, w8, ws, bias = _gemm_case(5, M, K, N, 40)
    want = jf.fc1_gelu_quant(jnp.asarray(a8), jnp.asarray(w8), jnp.asarray(ws),
                             jnp.asarray(bias), 1.1, 0.04, act)
    got = tf.fc1_gelu_quant(torch.from_numpy(a8), torch.from_numpy(w8.T.copy()),
                            torch.from_numpy(ws), torch.from_numpy(bias), 1.1, 0.04, act)
    _assert_int8_close(got, want)
    assert np.abs(np.asarray(want)).mean() > 5  # the case exercises the quantiser


def _qkv_case(seed, B, S, D, shift):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (B, S, D)).astype(np.int8)
    wq = rng.integers(-127, 128, (3, D, D)).astype(np.int8)  # JAX (3, K, N)
    ws = (rng.uniform(0.5, 1.5, (3, 1, D)) / (127 * 60 * D ** 0.5)).astype(np.float32)
    bias = (rng.normal(size=(3, 1, D)) * 0.1).astype(np.float32)
    sq = sk = np.float32(2.5 / 127)
    sm = np.float32((D // 4) ** -0.5)
    scales6 = np.array([1.0, np.float32(1) / sq, np.float32(1) / sk, shift, sq * sk * sm,
                        127 / 0.6], np.float32)
    return xq, wq, ws, bias, scales6


@pytest.mark.parametrize("S,kv_len,shift", [(17, 17, 6.0), (24, 20, 6.0), (16, 16, 400.0)])
def test_qkv_attn_int8_matches_pallas(S, kv_len, shift):
    B, D, H = 2, 128, 4
    xq, wq, ws, bias, s6 = _qkv_case(3, B, S, D, shift)
    want = jf.qkv_attn_int8(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(ws),
                            jnp.asarray(bias), jnp.asarray(s6).reshape(6, 1), H, kv_len,
                            out_dtype=jnp.int8, static_smax=True, allow_packed=False,
                            block_imgs=2)
    got = tf.qkv_attn_int8(torch.from_numpy(xq), torch.from_numpy(wq.swapaxes(1, 2).copy()),
                           torch.from_numpy(ws), torch.from_numpy(bias), s6.tolist(), H, kv_len)
    _assert_int8_close(got[:, :kv_len], np.asarray(want)[:, :kv_len])
    if shift > 100:  # a stabiliser that drowns every row: zeros, not NaN
        assert not got.any() and not np.asarray(want).any()
    else:
        assert np.abs(np.asarray(want)).mean() > 5


# K7c (int8 o, K = D) and K7g at the row edges of the card's 128-row tiles
# (K7e's kernel for K7c; the persistent QKV projection for K7g), at widths
# 128 and 256 (K7g with heads of 64)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("M", [127, 128, 129])
def test_oproj_ln_quant_matches_pallas_at_tile_edges(dtype, D, M):
    rng, a8, w8, ws, bias = _gemm_case(6, M, D, D, 60)
    x_res = rng.normal(size=(M, D)).astype(np.float32)
    lnw = rng.uniform(0.5, 1.5, D).astype(np.float32)
    lnb = (rng.normal(size=D) * 0.1).astype(np.float32)
    jres, tres = _pair(x_res, dtype)
    jx, jxq = jf.oproj_ln_quant(jnp.asarray(a8), jres, jnp.asarray(w8), jnp.asarray(ws),
                                jnp.asarray(bias), jnp.asarray(lnw), jnp.asarray(lnb), 1.3,
                                0.025, 1e-5)
    tx, txq = tf.oproj_ln_quant(torch.from_numpy(a8), tres, torch.from_numpy(w8.T.copy()),
                                torch.from_numpy(ws), torch.from_numpy(bias),
                                torch.from_numpy(lnw), torch.from_numpy(lnb), 1.3, 0.025, 1e-5)
    _assert_within_ulp(tx, np.asarray(jx, np.float32), DTYPES[dtype][1])
    _assert_int8_close(txq, jxq)


@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("M", [127, 128, 129])
def test_qkv_attn_int8_matches_pallas_at_tile_edges(D, M):
    H = D // 64
    xq, wq, ws, bias, s6 = _qkv_case(7, 1, M, D, 6.0)
    s6[4] = np.float32(2.5 / 127) ** 2 * np.float32(64 ** -0.5)
    want = jf.qkv_attn_int8(jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(ws),
                            jnp.asarray(bias), jnp.asarray(s6).reshape(6, 1), H, M,
                            out_dtype=jnp.int8, static_smax=True, allow_packed=False,
                            block_imgs=1)
    got = tf.qkv_attn_int8(torch.from_numpy(xq), torch.from_numpy(wq.swapaxes(1, 2).copy()),
                           torch.from_numpy(ws), torch.from_numpy(bias), s6.tolist(), H, M)
    _assert_int8_close(got, np.asarray(want))
    assert np.abs(np.asarray(want)).mean() > 5


def test_qkv_project_twin_is_k7b_on_the_same_operands():
    # K7g's projection and K7b run one kernel on the card: the projection's
    # twin is K7b's int8 q, k and bf16 v
    xq, wq, ws, bias, s6 = _qkv_case(8, 2, 70, 128, 6.0)
    txq, twq = torch.from_numpy(xq).view(140, 128), torch.from_numpy(wq.swapaxes(1, 2).copy())
    tws, tb = torch.from_numpy(ws), torch.from_numpy(bias)
    q8, k8, v = tf._qkv_project(txq, twq, tws, tb, float(s6[0]), float(s6[1]), float(s6[2]))
    q8b, k8b, _ = tf.qkv_int8(txq, twq, tws, tb, float(s6[0]),
                              qkv_scales=[1 / float(s6[1]), 1 / float(s6[2]), 1.0])
    assert torch.equal(q8, q8b) and torch.equal(k8, k8b)
    assert torch.equal(v, tf.qkv_int8(txq, twq, tws, tb, float(s6[0]))[2])
    assert (q8.dtype, k8.dtype, v.dtype) == (torch.int8, torch.int8, torch.bfloat16)
    with pytest.raises(ValueError, match="is not"):
        tf._qkv_project(txq, twq[:2], tws, tb, 1.0, 1.0, 1.0)


def test_unported_variants_raise():
    # the flags that measured as washes on the TPU stay refused; (L, 4) and
    # (L, 7) calibrations, int8_o=False and fuse_l=False are ported
    # (tests/test_torch_vit_int8_variants.py)
    xq, wq, ws, bias, s6 = (torch.from_numpy(a) for a in _qkv_case(4, 1, 8, 128, 6.0))
    for flag in ("bf16_qk", "store_p", "bf16_scores", "ph_exp2", "allow_packed"):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
            tf.qkv_attn_int8(xq, wq, ws, bias, s6.tolist(), 4, 8, **{flag: True})
    cfg = _port_cfg(_small_cfg("float32"))
    for flag in ("bf16_qk", "store_p", "bf16_scores", "ph_exp2", "fast_ln"):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 2"):
            tf.vit_forward_int8_fused({}, cfg, torch.zeros(1, 28, 28, 3), torch.ones(3, 8),
                                      **{flag: True})


# ----------------------------------------------------------------------
# Host side: packing, calibration, smoothing
# ----------------------------------------------------------------------
@pytest.fixture(scope="module", params=list(DTYPES))
def small_tower(request):
    jcfg = _small_cfg(request.param)
    params = init_vit_params(jax.random.PRNGKey(0), jcfg)
    pixels = _pixels(1, 4)
    return request.param, jcfg, params, _port_tree(jcfg, params), pixels


def test_pack_int8_leaves_bitwise(small_tower):
    _, jcfg, params, tree, _ = small_tower
    want = jf.pack_vit_int8_fused(params)
    got = tf.pack_vit_int8_fused(tree)
    assert set(got) == set(want)
    for key, val in want.items():
        val = np.asarray(val)
        if val.dtype == np.int8:
            np.testing.assert_array_equal(got[key].transpose(-1, -2).numpy(), val, err_msg=key)
        else:
            np.testing.assert_allclose(_np(got[key]), val.astype(np.float32), rtol=1e-6,
                                       err_msg=key)


def test_calibrate_and_smooth_match_jax_f32():
    jcfg = _small_cfg("float32")
    params = perturbed(init_vit_params(jax.random.PRNGKey(5), jcfg), seed=2)
    tree, cfg = _port_tree(jcfg, params), _port_cfg(jcfg)
    pixels = _pixels(6, 4)
    jsm = jf.smooth_vit_params(params, jcfg, jnp.asarray(pixels))
    tsm = tf.smooth_vit_params(tree, cfg, torch.from_numpy(pixels))
    for key, val in jsm["layers"].items():
        val = np.asarray(val, np.float32)
        err = np.abs(_np(tsm["layers"][key]) - val).max() / max(np.abs(val).max(), 1e-12)
        assert err <= 1e-4, key
    want = np.asarray(jf.calibrate_vit_int8_fused(jsm, jcfg, jnp.asarray(pixels)))
    got = tf.calibrate_vit_int8_fused(tsm, cfg, torch.from_numpy(pixels)).numpy()
    assert got.shape == (3, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    want4 = np.asarray(jq.calibrate_act_scales(params, jcfg, jnp.asarray(pixels)))
    got4 = tq.calibrate_act_scales(tree, cfg, torch.from_numpy(pixels)).numpy()
    np.testing.assert_allclose(got4, want4, rtol=1e-4)


# ----------------------------------------------------------------------
# Whole towers
# ----------------------------------------------------------------------
def test_fused_tower_matches_jax_and_bf16(small_tower):
    dtype, jcfg, params, tree, pixels = small_tower
    cfg = _port_cfg(jcfg)
    jscales = jf.calibrate_vit_int8_fused(params, jcfg, jnp.asarray(pixels))
    jpacked = jf.pack_vit_int8_fused(params)
    want = jf.vit_forward_int8_fused(jpacked, jcfg, jnp.asarray(pixels), jscales)
    scales = tf.calibrate_vit_int8_fused(tree, cfg, torch.from_numpy(pixels))
    packed = tf.pack_vit_int8_fused(tree)
    # the same packed tree and calibration as JAX: the forward alone
    got = tf.vit_forward_int8_fused(packed, cfg, torch.from_numpy(pixels),
                                    torch.tensor(np.asarray(jscales)))
    assert got.shape == want.shape and got.dtype == DTYPES[dtype][1]
    assert _cosine(_np(got), want) >= 0.9999
    # the port's own calibration, against the float tower (JAX's :68-73, :89-103)
    own = tf.vit_forward_int8_fused(packed, cfg, torch.from_numpy(pixels), scales)
    ref = vit_forward(params, jcfg, jnp.asarray(pixels))
    assert _cosine(_np(own), ref) > 0.999


def test_unfused_tower_matches_jax(small_tower):
    dtype, jcfg, params, tree, pixels = small_tower
    cfg = _port_cfg(jcfg)
    jscales = jq.calibrate_act_scales(params, jcfg, jnp.asarray(pixels))
    want = jq.vit_forward_int8(jq.quantize_vit_params(params), jcfg, jnp.asarray(pixels),
                               act_scales=jscales)
    qtree = tq.quantize_vit_params(tree)
    got = tq.vit_forward_int8(qtree, cfg, torch.from_numpy(pixels),
                              act_scales=torch.tensor(np.asarray(jscales)))
    assert _cosine(_np(got), want) >= 0.9999
    dyn = jq.vit_forward_int8(jq.quantize_vit_params(params), jcfg, jnp.asarray(pixels))
    assert _cosine(_np(tq.vit_forward_int8(qtree, cfg, torch.from_numpy(pixels))), dyn) >= 0.9999


def test_fused_no_cls_variant():
    # JAX's :131: a SigLIP-style tower (no CLS, no pre-LN, post-LN, patch bias, tanh gelu)
    jcfg = _small_cfg("bfloat16", num_layers=2, use_cls_token=False, use_pre_layernorm=False,
                      post_layernorm_output=True, patch_bias=True,
                      hidden_act="gelu_pytorch_tanh")
    params = perturbed(init_vit_params(jax.random.PRNGKey(2), jcfg), seed=3, scale=0.02)
    pixels = _pixels(3, 2)
    tree, cfg = _port_tree(jcfg, params), _port_cfg(jcfg)
    jscales = jf.calibrate_vit_int8_fused(params, jcfg, jnp.asarray(pixels))
    want = jf.vit_forward_int8_fused(jf.pack_vit_int8_fused(params), jcfg, jnp.asarray(pixels),
                                     jscales)
    got = tf.vit_forward_int8_fused(tf.pack_vit_int8_fused(tree), cfg, torch.from_numpy(pixels),
                                    torch.tensor(np.asarray(jscales)))
    assert got.shape == want.shape == (2, 4, 128)
    assert _cosine(_np(got), want) >= 0.9999
    own = tf.vit_forward_int8_fused(tf.pack_vit_int8_fused(tree), cfg, torch.from_numpy(pixels),
                                    tf.calibrate_vit_int8_fused(tree, cfg,
                                                                torch.from_numpy(pixels)))
    assert _cosine(_np(own), vit_forward(params, jcfg, jnp.asarray(pixels))) > 0.999


def test_fused_outlier_channel_fidelity():
    """JAX's :279-339 on the port: heavy-tailed output channels (crc32
    pattern); smoothing lifts the cosine against the float tower by >= 0.005
    and above 0.992."""
    jcfg = _small_cfg("bfloat16")
    params = init_vit_params(jax.random.PRNGKey(7), jcfg)

    def inject(path, x):
        name = path[-1].key if hasattr(path[-1], "key") else str(path[-1])
        if x.ndim >= 2 and "proj" in name:
            rng = np.random.default_rng(zlib.crc32(name.encode()))
            scale = np.where(rng.random(x.shape[-1]) < 0.03,
                             rng.uniform(8.0, 16.0, x.shape[-1]), 1.0)
            return (x.astype(jnp.float32) * scale).astype(x.dtype)
        return x

    params = jax.tree_util.tree_map_with_path(inject, params)
    pixels = torch.from_numpy(_pixels(8, 4))
    vit = ViT(_port_cfg(jcfg), device="cpu")
    load_jax_params(vit, jax.tree.map(np.asarray, params))
    tree, cfg = tq.vit_params_tree(vit), vit.cfg
    with torch.no_grad():
        ref = vit(pixels).float().numpy()

    def int8(t):
        return tf.vit_forward_int8_fused(tf.pack_vit_int8_fused(t), cfg, pixels,
                                         tf.calibrate_vit_int8_fused(t, cfg, pixels))

    raw = _cosine(_np(int8(tree)), ref)
    smooth = _cosine(_np(int8(tf.smooth_vit_params(tree, cfg, pixels))), ref)
    assert smooth > 0.992, (smooth, raw)
    assert smooth > raw + 0.005


# ----------------------------------------------------------------------
# Projector, modality, conversion
# ----------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_int8_projector_matches_jax(dtype):
    params = perturbed(jproj.init_mlp_projector(jax.random.PRNGKey(2), 64, 96,
                                                DTYPES[dtype][0]))
    x = np.random.default_rng(3).normal(size=(2, 5, 64)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    want = jproj.mlp_projector_forward_int8(jproj.quantize_mlp_projector(params), jx)
    proj = tproj.MLPProjector(64, 96, dtype=DTYPES[dtype][1], device="cpu")
    load_jax_params(proj, jax.tree.map(np.asarray, params))
    qp = tproj.quantize_mlp_projector(tproj.mlp_projector_tree(proj))
    for key, val in jproj.quantize_mlp_projector(params).items():
        if key.endswith("_q"):
            np.testing.assert_array_equal(qp[key].t().numpy(), np.asarray(val))
    got = tproj.mlp_projector_forward_int8(qp, tx)
    assert got.dtype == DTYPES[dtype][1]
    assert _cosine(_np(got), want) >= 0.9999


def _modality_case(wire, tower_dtype="float32"):
    jcfg = dataclasses.replace(tiny_image_config(), wire_dtype=wire, param_dtype=tower_dtype,
                               image_size=28, patch_size=14, vision_hidden_size=64,
                               vision_layers=2, vision_heads=2, vision_intermediate_size=128)
    jmod = JImageModality(jcfg)
    params = perturbed(jmod.init_params(jax.random.PRNGKey(4)), scale=0.02)
    rng = np.random.default_rng(5)
    if wire == "uint8":
        values = rng.integers(0, 256, (4, 28, 28, 3)).astype(np.uint8)
    else:
        values = rng.normal(size=(4, 28, 28, 3)).astype(np.float32)
    tmod = TImageModality(TImageConfig(**dataclasses.asdict(jcfg)), device="cpu")
    load_jax_params(tmod, jax.tree.map(np.asarray, params))
    return jmod, params, tmod, values


@pytest.mark.parametrize("fused,wire", [(True, "uint8"), (True, "float32"),
                                        (False, "float32")])
def test_modality_quantize_then_encode_matches_jax(fused, wire):
    jmod, params, tmod, values = _modality_case(wire)
    qparams = jmod.quantize_params(params, calibration_values=values, fused=fused)
    want = jmod.encode(qparams, jnp.asarray(values))
    master = {n: p.detach().clone() for n, p in tmod.named_parameters()}
    tower = tmod.quantize_params(torch.from_numpy(values), fused=fused)
    assert isinstance(tower, tf.ViTInt8Fused if fused else tq.ViTInt8)
    assert tmod.embedder_q is tower
    for n, p in tmod.named_parameters():  # the float master tower stays as it is
        assert torch.equal(p, master[n]), n
    with torch.no_grad():
        got = tmod.encode(torch.from_numpy(values))
    assert _cosine(_np(got), want) >= 0.9999
    # JAX's int8 tree carried across by load_jax_params gives JAX's encode too
    other = TImageModality(tmod.config, device="cpu")
    load_jax_params(other, jax.tree.map(np.asarray, qparams))
    with torch.no_grad():
        assert _cosine(_np(other.encode(torch.from_numpy(values))), want) >= 0.9999


def test_fused_quantize_needs_calibration_values():
    _, _, tmod, _ = _modality_case("uint8")
    with pytest.raises(ValueError, match="calibration_values"):
        tmod.quantize_params(fused=True)


@pytest.mark.parametrize("fused", [True, False])
def test_convert_int8_tower_round_trip(fused):
    jmod, params, tmod, values = _modality_case("uint8")
    qparams = jax.tree.map(np.asarray, jmod.quantize_params(params, calibration_values=values,
                                                           fused=fused))
    load_jax_params(tmod, qparams)
    back = export_jax_params(tmod)
    assert jax.tree.structure(back) == jax.tree.structure(qparams)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(back),
                                 jax.tree_util.tree_leaves_with_path(qparams)):
        assert a.shape == b.shape, jax.tree_util.keystr(path)
        if b.dtype == np.int8:
            assert a.dtype == np.int8
            np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))
        else:
            np.testing.assert_array_equal(a, b.astype(np.float32),
                                          err_msg=jax.tree_util.keystr(path))
