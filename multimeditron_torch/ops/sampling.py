"""The serving engine's sampler: JAX's threefry Gumbel-max draw, one pass.

:func:`sample` takes (n, V) logits, the rows' temperatures and a threefry
key and returns one int32 token a row, as ``ServingEngine._sample`` composes
it without top-k or top-p: the greedy argmax of the float32 logits where the
temperature is at most 1e-6, else ``prng.categorical`` of the logits over
``max(t, 1e-6)``. :func:`gumbel_argmax` is ``prng.categorical`` itself: the
argmax of logits + Gumbel noise, for logits already scaled (and filtered by
:func:`filter_logits`, the eager top-k / top-p thresholds); the engine's
filtered draws and ``generation.sample_tokens`` call both.

A CUDA tensor runs ``csrc/gumbel_argmax.cu`` (one pass over the logits,
bf16 or float32, then one small launch that reduces each row's blocks; no
host synchronisation, so the decode step's CUDA graph captures it), whose
tokens are the eager chain's bit for bit. A CPU tensor runs the plain twin,
:func:`sample_plain` or ``prng.categorical``: ``serve/prng.py``'s int64
threefry. This module alone chooses between them.

The key is one key, ``(2,)`` int64 words, whose counters run flat over the
(n, V) tensor, or one key a row, ``(n, 2)``, whose counters restart at 0 on
every row (``prng.random_bits``). One key on the CPU enters the kernel as
two arguments; a key on the card is read there at each launch, so a graph
replay draws with whatever its static key tensor holds.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from multimeditron_torch import _build
from multimeditron_torch.serve import prng

# Launches of the CUDA entry point (the plain twin does not count), counted by
# the calls made on the host: a captured CUDA graph counts once, at capture.
launches = {"gumbel_argmax": 0}

CHUNK = 2048  # columns a block of the kernel takes (csrc/gumbel_argmax.cu kChunk)
MIN_TEMP = 1e-6  # a row at or below it is greedy


def sample_plain(logits: torch.Tensor, temps: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """The twin, on any device: the engine's eager composition."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / torch.clamp(temps, min=MIN_TEMP)[:, None]
    sampled = prng.categorical(key, scaled).to(torch.int32)
    return torch.where(temps > MIN_TEMP, sampled, greedy)


def filter_logits(scaled: torch.Tensor, top_k: Optional[int],
                  top_p: Union[float, torch.Tensor, None]) -> torch.Tensor:
    """(n, V) logits over the temperature -> the same with -inf below the
    top-k threshold (``top_k`` None or 0: none), then below the nucleus
    cutoff (inclusive of the token that crosses ``top_p``): ``top_p`` is one
    float for every row (None or 1.0: no nucleus) or an (n,) tensor."""
    if top_k is not None and top_k > 0:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, -torch.inf, scaled)
    if isinstance(top_p, torch.Tensor) or (top_p is not None and top_p < 1.0):
        bound = top_p[:, None] if isinstance(top_p, torch.Tensor) else top_p
        sorted_logits = torch.sort(scaled, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = (cum < bound).sum(dim=-1, keepdim=True).clamp(max=scaled.shape[-1] - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        scaled = torch.where(scaled < cutoff, -torch.inf, scaled)
    return scaled


def _c_int(word: int) -> int:
    """A uint32 word as the C ``int`` that holds its bits."""
    return word - (1 << 32) if word >= 1 << 31 else word


def _check(logits: torch.Tensor, temps, key: torch.Tensor) -> None:
    """Raise on what the kernel does not take (on either device, so that the
    twin serves exactly the calls that the kernel serves)."""
    if logits.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the sampler runs on cpu or cuda, not {logits.device}")
    if logits.dim() != 2 or logits.dtype not in _build.DTYPE_CODES or not logits.is_contiguous():
        raise ValueError(f"the sampler takes contiguous (n, V) float32 or bfloat16 logits, got "
                         f"{tuple(logits.shape)} {logits.dtype}"
                         f"{'' if logits.is_contiguous() else ', not contiguous'}")
    n, V = logits.shape
    if n < 1 or V < 1:
        raise ValueError(f"the sampler takes at least one row and one column, got {(n, V)}")
    if temps is not None and (temps.shape != (n,) or temps.dtype != torch.float32
                              or temps.device != logits.device or not temps.is_contiguous()):
        raise ValueError(f"temps must be a contiguous float32 ({n},) tensor on {logits.device}")
    if key.dtype != torch.int64 or key.shape not in ((2,), (n, 2)) or not key.is_contiguous():
        raise ValueError(f"a key is contiguous int64 (2,) words, or ({n}, 2) for one a row; "
                         f"got {tuple(key.shape)} {key.dtype}")
    if key.dim() == 1 and n * V >= 2 ** 32:
        raise ValueError("more than 2**32 random words from one key")


def _launch(logits: torch.Tensor, temps, key: torch.Tensor) -> torch.Tensor:
    """Run the kernel on checked operands: (n,) int32 tokens."""
    (n, V), dev = logits.shape, logits.device
    k1 = k2 = 0
    if key.dim() == 1 and key.device.type == "cpu":
        k1, k2 = int(key[0]), int(key[1])
        key_ptr, stride = None, 0
    else:
        key = key.to(dev)
        key_ptr, stride = key.data_ptr(), 2 * (key.dim() - 1)
    splits = -(-V // CHUNK)
    partial = torch.empty(n * splits * 4, dtype=torch.int32, device=dev)
    tokens = torch.empty(n, dtype=torch.int32, device=dev)
    code = _build.library().mmt_gumbel_argmax(
        logits.data_ptr(), None if temps is None else temps.data_ptr(), key_ptr, stride,
        _c_int(k1), _c_int(k2), partial.data_ptr(), tokens.data_ptr(), n, V, splits,
        _build.DTYPE_CODES[logits.dtype], _build.stream_handle(dev))
    _build.check("gumbel_argmax", code)
    launches["gumbel_argmax"] += 1
    return tokens


def sample(logits: torch.Tensor, temps: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """(n, V) logits, (n,) float32 temperatures, a key -> (n,) int32 tokens."""
    _check(logits, temps, key)
    if logits.is_cuda:
        return _launch(logits, temps, key)
    return sample_plain(logits, temps, key)


def gumbel_argmax(logits: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """``prng.categorical(key, logits)`` on (n, V) logits -> (n,) int32."""
    _check(logits, None, key)
    if logits.is_cuda:
        return _launch(logits, None, key)
    return prng.categorical(key, logits).to(torch.int32)
