"""roofline.py's counts against shapes counted by hand."""

import dataclasses

import pytest

import roofline
import spec

TINY = spec.architecture("dense").Dims(
    D=4, L=1, H=2, Hkv=1, Dh=2, F=8, V=10, gated=True, tied=False, act="silu", rope_theta=1e4,
    rope_scaling=None, eps=1e-6, eos=0, img=28, patch=14, Dv=4, Lv=1, Hv=2, Fv=8, eps_v=1e-5)


def test_parameter_counts_by_hand():
    # q 4x4, k 4x2, v 4x2, o 4x4 = 48; gate, up, down 3 x 4x8 = 96;
    # norms: 2 x 4 + qk-norm 2 x 2 = 12
    assert TINY.layer_params == 156
    assert TINY.body_params == 160          # + the final norm
    assert TINY.decoder_params == 160 + 40 + 40
    assert dataclasses.replace(TINY, tied=True).decoder_params == 200
    # projector 4x4+4, 4x4+4, 4x4+4
    assert TINY.projector_params == 60
    # tower layer: 4 x (16 + 4) + (32 + 8) + (32 + 4) + 4 norms x 4 = 172
    assert TINY.tower_layer_params == 172
    # stem: patch 14*14*3 x 4, position 5 x 4, cls 4, pre-LN 8; post-LN 8
    assert TINY.tower_params == 588 * 4 + 20 + 4 + 8 + 172 + 8


def test_decode_step_by_hand():
    # one slot attending over 3 keys: 2 x (160 + 40) + 4 x 3 x 2 x 2
    assert roofline.decode_step_flops(TINY, [3]) == 448
    # weights (160 + 40) x 2 bytes; K/V of 3 read + 1 written, 1 layer x 2 x 1 x 2 x 2
    assert roofline.decode_step_bytes(TINY, [3]) == 400 + 4 * 8
    assert roofline.decode_step_bound_s(TINY, [3]) == pytest.approx(
        max(448 / roofline.PEAK_BF16, 432 / roofline.HBM_BYTES_PER_S))


def test_prefill_by_hand():
    # 3 tokens, no image: 2 x 160 x 3 + 4 x 6 pairs x 4 + the head at one position 2 x 40
    assert roofline.prefill_flops(TINY, 3, 0) == 960 + 96 + 80
    # the tower: 4 patches + CLS = 5 tokens, patch projection over 4 patches
    per_layer = 2 * 5 * (4 * 16 + 2 * 32) + 4 * 25 * 4
    assert roofline.tower_flops(TINY) == 2 * 4 * 588 * 4 + per_layer
    assert roofline.projector_flops(TINY) == 2 * 4 * 48


def test_train_step_by_hand():
    # rows of 2 and 3 tokens, 3 labelled, one image
    dec = 4 * 160 * 5 + 3.5 * 4 * (3 + 6) * 4
    head = 4 * 40 * 3
    img = roofline.tower_flops(TINY) + 6 * 4 * 48
    assert roofline.train_step_flops(TINY, [2, 3], [1, 2], 1) == dec + head + img


def test_kernel_bounds_by_hand():
    # K3, one image: 4 x 25 x 4 flops; q, k, v, o of 5 x 4 in bf16
    assert roofline.k3_bound_s(TINY, 1) == pytest.approx(
        max(400 / roofline.PEAK_BF16, 160 / roofline.HBM_BYTES_PER_S))
    # K4: 2 slots, 7 keys, 5 distinct K/V tokens read
    assert roofline.k4_bound_s(TINY, 2, 7, 5) == pytest.approx(
        max(4 * 7 * 4 / roofline.PEAK_BF16, (5 * 2 * 2 * 2 + 2 * 2 * 4 * 2)
            / roofline.HBM_BYTES_PER_S))
    b = roofline.flash_bounds_s(TINY, [3])
    assert b["k1"] == pytest.approx(max(4 * 6 * 4 / roofline.PEAK_BF16,
                                        (3 * 12 * 2 + 3 * 2 * 4) / roofline.HBM_BYTES_PER_S))
    assert b["k2a"] >= b["k1"] and b["k2b"] >= b["k1"]


def test_forked_decode_step_by_hand():
    # slots of 5, 5 and 7 keys; the two of 5 a forked group sharing a 4-token
    # prefix read once: 17 keys attended, 13 K/V tokens read
    lens, shared = [5, 5, 7], ((1, 4, 5),)
    assert roofline.step_keys(TINY, 0, lens, shared) == (17, 13)
    # weights 400 bytes; K/V of 13 read + 3 written, 8 bytes a token
    assert roofline.decode_step_bytes(TINY, lens, shared) == 400 + 16 * 8
    two = dataclasses.replace(TINY, L=2)
    assert roofline.k4_step_bound_s(two, lens, shared) == 2 * roofline.k4_bound_s(two, 3, 17, 13)


def test_no_share_of_the_full_size_can_pass_its_bound():
    """A decode step over 32 slots of 1,000 keys is bound by its bytes,
    and its bound is over the weights' read time alone."""
    d = spec.dims(spec.load_config("apertus-8b-clip-l14"))
    t = roofline.decode_step_bound_s(d, [1000] * 32)
    weights = (d.body_params + d.V * d.D) * 2 / roofline.HBM_BYTES_PER_S
    assert t > weights
    assert roofline.decode_step_flops(d, [1000] * 32) / roofline.PEAK_BF16 < t
