"""The sampler's wrapper on the CPU (``multimeditron_torch/ops/sampling.py``):
CPU tensors take the plain twin and launch nothing, the checks refuse what
the kernel does not take, and the twin's fused form (temperature, greedy,
Gumbel-max draw, select) is the engine's eager composition over one key and
over one key a row. The kernel itself is held to the twin on the card
(``tests/test_torch_cuda.py``)."""

import types

import pytest
import torch

from multimeditron_torch.ops import sampling
from multimeditron_torch.serve import prng
from multimeditron_torch.serve.engine import EngineConfig, ServingEngine

SEEDS = [0, 7, 2 ** 31 - 1, 123_456_789]


def _case(rows, V, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    logits = (torch.randn(rows, V, generator=g) * 3).to(dtype)
    temps = torch.tensor([0.0, 0.7, 1.0]).repeat(rows // 3 + 1)[:rows].contiguous()
    return logits, temps


def _key(seed, rows, per_row):
    key = prng.split(prng.prng_key(seed))[1]
    return prng.fold_in(key, torch.arange(rows) * (1 << 20) + 40) if per_row else key


def _composition(logits, temps, key):
    """``ServingEngine._sample`` as the eager chain composed it, step by step."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / torch.clamp(temps, min=1e-6)[:, None]
    sampled = prng.categorical(key, scaled).to(torch.int32)
    return torch.where(temps > 1e-6, sampled, greedy)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_twin_and_launch_nothing(dtype, per_row):
    logits, temps = _case(6, 300, dtype)
    before = sampling.launches["gumbel_argmax"]
    for seed in SEEDS:
        key = _key(seed, 6, per_row)
        got = sampling.sample(logits, temps, key)
        assert got.dtype == torch.int32 and got.shape == (6,)
        assert torch.equal(got, sampling.sample_plain(logits, temps, key))
        drawn = sampling.gumbel_argmax(logits.float(), key)
        assert drawn.dtype == torch.int32
        assert torch.equal(drawn.long(), prng.categorical(key, logits.float()))
    assert sampling.launches["gumbel_argmax"] == before


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("rows,V", [(6, 300), (3, 2048), (5, 4099)])
def test_twin_is_the_engines_eager_composition(rows, V, per_row):
    logits, temps = _case(rows, V, torch.bfloat16, seed=V)
    for seed in SEEDS:
        key = _key(seed, rows, per_row)
        assert torch.equal(sampling.sample_plain(logits, temps, key),
                           _composition(logits, temps, key))


def _engine_like(**cfg):
    """Enough of a ServingEngine to call its ``_sample``."""
    return types.SimpleNamespace(cfg=EngineConfig(**cfg), n_kernel_samples=0)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("filters", [{}, {"top_k": 40}, {"top_p": 0.9}])
def test_engine_sample_on_the_cpu(filters, per_row):
    """``_sample`` without filters draws through the wrapper, with a filter
    through the eager filter and ``sampling.gumbel_argmax``; on the CPU both give
    the eager composition's tokens (the filter's own for a filtered row) and
    count no kernel call."""
    eng = _engine_like(**filters)
    logits, temps = _case(6, 300, torch.float32, seed=3)
    top_ps = torch.full((6,), 0.9)
    for seed in SEEDS:
        key = _key(seed, 6, per_row)
        got = ServingEngine._sample(eng, logits, temps, top_ps, key)
        scaled = sampling.filter_logits(logits / torch.clamp(temps, min=1e-6)[:, None],
                                        eng.cfg.top_k, top_ps if eng.cfg.top_p < 1.0 else None)
        sampled = prng.categorical(key, scaled).to(torch.int32)
        want = torch.where(temps > 1e-6, sampled, torch.argmax(logits, -1).to(torch.int32))
        assert torch.equal(got, want)
    assert eng.n_kernel_samples == 0
    greedy = ServingEngine._sample(_engine_like(do_sample=False), logits, temps, top_ps, None)
    assert torch.equal(greedy, torch.argmax(logits, -1).to(torch.int32))


def test_engine_sample_takes_a_forks_expanded_logits():
    """A fork's siblings share one row of logits (an expanded view): the
    engine hands the wrapper a contiguous copy."""
    eng = _engine_like()
    row, temps = _case(1, 300, torch.float32)
    logits = row[0].expand(4, -1)
    temps = torch.tensor([1.0, 0.7, 0.0, 1.0])
    key = _key(5, 4, False)
    got = ServingEngine._sample(eng, logits, temps, torch.ones(4), key)
    assert torch.equal(got, _composition(logits.contiguous(), temps, key))


def test_verify_rows_equal_the_blockwise_composition():
    """The speculative verify draws each (slot, position) row with its
    slot's temperature and its position's key: ``_sample`` over the
    (B * (k + 1), V) rows equals the (B, k + 1, V) composition it replaced."""
    eng = _engine_like()
    B, k, V = 3, 2, 257
    g = torch.Generator().manual_seed(1)
    logits = torch.randn(B, k + 1, V, generator=g) * 3
    temps = torch.tensor([0.0, 0.7, 1.0])
    keys = prng.fold_in(prng.prng_key(9), torch.arange(B * (k + 1)) + 100)
    got = ServingEngine._sample(eng, logits.reshape(B * (k + 1), -1),
                                temps.repeat_interleave(k + 1), torch.ones(B * (k + 1)),
                                keys).reshape(B, k + 1)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = (logits / torch.clamp(temps, min=1e-6)[:, None, None]).reshape(-1, V)
    sampled = prng.categorical(keys, scaled).reshape(B, k + 1).to(torch.int32)
    assert torch.equal(got, torch.where(temps[:, None] > 1e-6, sampled, greedy))


def _bad_calls():
    logits, temps = _case(4, 64, torch.float32)
    key, keys = _key(0, 4, False), _key(0, 4, True)
    return {
        "float16 logits": (logits.half(), temps, key),
        "float64 logits": (logits.double(), temps, key),
        "int logits": (logits.long(), temps, key),
        "1-D logits": (logits[0], temps[:1], key),
        "3-D logits": (logits[None], temps, key),
        "no rows": (logits[:0], temps[:0], key),
        "strided logits": (logits[:, ::2], temps, key),
        "transposed logits": (logits.t(), temps, key),
        "temps of another length": (logits, temps[:3], key),
        "float64 temps": (logits, temps.double(), key),
        "3-word key": (logits, temps, torch.zeros(3, dtype=torch.int64)),
        "int32 key": (logits, temps, key.to(torch.int32)),
        "keys for other rows": (logits, temps, _key(0, 5, True)),
        "keys of 3 words": (logits, temps, torch.zeros(4, 3, dtype=torch.int64)),
        "strided keys": (logits, temps, keys.t().contiguous().t()),
        "a key a column": (logits, temps, torch.zeros(4, 64, 2, dtype=torch.int64)),
    }


@pytest.mark.parametrize("name", list(_bad_calls()))
def test_sampler_refuses_what_the_kernel_does_not_take(name):
    logits, temps, key = _bad_calls()[name]
    before = sampling.launches["gumbel_argmax"]
    with pytest.raises(ValueError):
        sampling.sample(logits, temps, key)
    if name.endswith("logits") or "key" in name:
        with pytest.raises(ValueError):
            sampling.gumbel_argmax(logits, key)
    assert sampling.launches["gumbel_argmax"] == before


def test_host_key_words_reach_c_as_their_bits():
    for word in (0, 1, 2 ** 31 - 1, 2 ** 31, 0x9E3779B1, 2 ** 32 - 1):
        assert sampling._c_int(word) % 2 ** 32 == word
        assert -2 ** 31 <= sampling._c_int(word) < 2 ** 31
