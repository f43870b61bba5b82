"""The traffic generator: deterministic per seed, the stated distributions
and rates, and the same work for every seed."""

import numpy as np
import pytest

import spec
import traffic

LOGN = {"dist": "lognormal", "median": 200, "sigma": 0.8, "min": 32, "max": 768}


def test_quantiles_follow_the_stated_distribution():
    x = traffic.quantiles(LOGN, 2001)
    assert x.min() >= 32 and x.max() <= 768
    assert abs(np.median(x) - 200) <= 1
    # the clip bites at both ends: 32 is z = -2.29, 768 is z = +1.68
    assert (x == 32).mean() == pytest.approx(0.011, abs=0.003)
    assert (x == 768).mean() == pytest.approx(0.046, abs=0.005)
    assert np.all(np.diff(x) >= 0)


def test_exponential_gaps_have_the_stated_rate():
    g = traffic.exp_gaps(2.5, 4000)
    assert g.mean() == pytest.approx(1 / 2.5, rel=0.01)
    assert np.median(g) == pytest.approx(np.log(2) / 2.5, rel=0.01)


@pytest.mark.parametrize("cell", ["apertus-8b.chat-img", "qwen3-4b.chat-longtext"])
def test_open_schedule_is_deterministic_and_the_same_work_for_every_seed(cell):
    wl = spec.load_workload(cell)
    tr = dict(wl["traffic"])
    d = spec.dims(spec.load_config(wl["config"]))
    a_off, a = traffic.open_schedule(tr, 40, 123456789012, d.V, d.img, d.n_patches)
    b_off, b = traffic.open_schedule(tr, 40, 123456789012, d.V, d.img, d.n_patches)
    c_off, c = traffic.open_schedule(tr, 40, 7, d.V, d.img, d.n_patches)
    assert np.array_equal(a_off, b_off)
    assert all(np.array_equal(x.ids, y.ids) for x, y in zip(a, b))
    assert not np.array_equal(a_off, c_off)
    # another seed: the same lengths, budgets and gaps in another order
    assert sorted(p.length for p in a) == sorted(p.length for p in c)
    assert sorted(p.out_tokens for p in a) == sorted(p.out_tokens for p in c)
    R = tr["ramp_s"]

    def window_gaps(off):
        seg = off[(off >= R) & (off < R + 40)]
        return np.sort(np.diff(np.append(seg, R + 40)))
    assert np.allclose(window_gaps(a_off), window_gaps(c_off))
    assert window_gaps(a_off).mean() == pytest.approx(1 / tr["rate_per_s"], rel=0.03)
    n = len(a)
    rate = tr["rate_per_s"]
    assert n == sum(round(rate * t) for t in (tr["ramp_s"], 40, tr["drain_s"]))
    assert a_off[0] == 0 and a_off[-1] < tr["ramp_s"] + 40 + tr["drain_s"]
    # the window holds the same requests for every seed
    win = lambda off, ps: sorted((p.length, p.out_tokens) for o, p in zip(off, ps)
                                 if tr["ramp_s"] <= o < tr["ramp_s"] + 40)
    assert win(a_off, a) == win(c_off, c) and len(win(a_off, a)) == round(rate * 40)
    assert sum(p.greedy for p in a) == -(-n // tr["greedy_every"])
    with_img = tr["images_per_request"] > 0
    for p in a[:20]:
        text = p.length - (d.n_patches if with_img else 0)
        assert tr["text_tokens"]["min"] <= text <= tr["text_tokens"]["max"]
        assert (p.image is not None) == with_img
        assert p.ids.min() >= 2 and p.ids.max() < d.V


def test_train_batches_layout():
    wl = spec.load_workload("qwen3-4b.align-train")
    tr = wl["traffic"]
    d = spec.dims(spec.load_config(wl["config"]))
    bs = traffic.train_batches(tr, 6, 99, d.V, d.img, d.n_patches)
    bs2 = traffic.train_batches(tr, 6, 99, d.V, d.img, d.n_patches)
    for b, b2 in zip(bs, bs2):
        assert np.array_equal(b["input_ids"], b2["input_ids"])
        B, S = b["input_ids"].shape
        valid = b["attention_mask"].sum(1)
        assert B == 4 and S % 512 == 0 and S <= 4096 and S - valid.max() < 512
        assert valid.min() >= 320
        user = tr["image_at"] + d.n_patches + tr["user_gap"]
        assert (b["labels"][:, :user] == -100).all()
        assert (b["labels"][b["attention_mask"] == 0] == -100).all()
        pack = b["mm_inputs"]["image"]
        assert pack["values"].shape == (8, 224, 224, 3)
        assert (pack["batch_idx"][: B * d.n_patches] < B).all()
        assert (pack["batch_idx"][B * d.n_patches:] == B).all()


def test_train_lengths_are_the_same_for_every_seed():
    tr = spec.load_workload("qwen3-4b.align-train")["traffic"]
    a = traffic.quantiles(tr["sample_tokens"], 320)
    assert a.min() == 320 and np.median(a) == pytest.approx(1536, abs=8)
    x = traffic.train_batches(tr, 2 * tr["block"], 1, 1000, 28, 4)
    y = traffic.train_batches(tr, 2 * tr["block"], 2, 1000, 28, 4)
    lens = lambda bs: sorted(int(v) for b in bs for v in b["attention_mask"].sum(1))
    assert lens(x) == lens(y)
