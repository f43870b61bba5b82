"""The serving engine's random numbers: JAX's threefry2x32, reproduced.

Counterpart of the ``jax.random`` calls the JAX engine makes
(``PRNGKey``, ``fold_in``, ``split``, ``categorical``), so that every token
the port samples equals the JAX engine's from the same logits. It follows
JAX 0.9 with ``jax_threefry_partitionable=True`` (``jax._src.prng``:
``threefry_seed``, ``_threefry_fold_in``, ``_threefry_split_foldlike``,
``_threefry_random_bits_partitionable``; ``jax._src.random``: ``_uniform``,
``_gumbel``, ``categorical``).

A key is a ``(..., 2)`` int64 tensor of two uint32 words. Every value is a
uint32 held in an int64 tensor and masked to 32 bits after each addition;
the hash also takes plain Python ints for the key words, so a key known on
the host never travels to the device. Random bits are made on the device of
the tensor they serve; the words of a key on that device are read there, so
a CUDA graph that captures a draw reads whatever key its static key tensor
holds at each replay. No draw builds a tensor from a host scalar.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
Word = Union[int, torch.Tensor]


def _rotl(x: Word, r: int) -> Word:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: Word, k2: Word, x1: Word, x2: Word):
    """The Threefry-2x32 hash of the counter pair (x1, x2) under the key
    (k1, k2): 20 rounds, five key injections (JAX's
    ``_threefry2x32_lowering``). Broadcasts like the arithmetic it does."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + i + 1) & _M32
    return x1, x2


def prng_key(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed: the words
    (0, seed mod 2**32), on the CPU."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} is not a 32-bit integer")
    return torch.tensor([0, seed & _M32], dtype=torch.int64)


def _words(key: torch.Tensor):
    """The key's two words, broadcastable against a batch of counters: Python
    ints for one key on the CPU, else (..., 1) tensors."""
    if key.shape[-1] != 2:
        raise ValueError(f"a key is (..., 2) words, got {tuple(key.shape)}")
    if key.dim() == 1 and key.device.type == "cpu":
        return int(key[0]), int(key[1])
    return key[..., :1], key[..., 1:]


def fold_in(key: torch.Tensor, data: Union[int, torch.Tensor]) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the counter (0, data).
    ``data`` may be a tensor of non-negative ints, giving one key per entry
    (a ``vmap`` of ``fold_in`` over it), on its device."""
    if isinstance(data, int):
        k1, k2 = _words(key)
        o1, o2 = threefry2x32(k1, k2, 0, data & _M32)
        return torch.tensor([o1, o2], dtype=torch.int64)
    if key.dim() != 1:
        raise ValueError("fold_in over a tensor of data takes one key")
    data = data.to(torch.int64) & _M32
    o1, o2 = threefry2x32(int(key[0]), int(key[1]), torch.zeros_like(data), data)
    return torch.stack([o1, o2], dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (num, 2) keys, the hashes of the
    counters (0, i)."""
    k1, k2 = _words(key)
    if isinstance(k1, int):  # a key on the host: hash with Python ints
        return torch.tensor([threefry2x32(k1, k2, 0, i) for i in range(num)],
                            dtype=torch.int64)
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    o1, o2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.stack([o1, o2], dim=-1)


def random_bits(key: torch.Tensor, shape: Sequence[int],
                device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """32 uniform bits per element of ``shape`` (JAX's partitionable
    ``random_bits``): the hash of each element's flat index, the two words
    XORed.

    ``key`` is one key, or one key per row ``(*shape[:-1], 2)``, which draws
    each row as ``jax.vmap`` over the rows would, with counters that restart
    at 0 on every row.
    """
    shape = tuple(shape)
    device = torch.device(device) if device is not None else key.device
    if key.dim() == 1:
        n = 1
        for d in shape:
            n *= d
        if n >= 2 ** 32:
            raise ValueError("more than 2**32 random words from one key")
        lo = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
        k1, k2 = _words(key)
    else:
        if key.shape[:-1] != shape[:-1]:
            raise ValueError(f"one key per row of {shape} needs keys of shape "
                             f"{shape[:-1] + (2,)}, got {tuple(key.shape)}")
        lo = torch.arange(shape[-1], dtype=torch.int64, device=device)
        k1, k2 = _words(key.to(device))
    if isinstance(k1, torch.Tensor):
        k1, k2 = k1.to(device), k2.to(device)
    b1, b2 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return torch.broadcast_to(b1 ^ b2, shape)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """float32 ``jax.random.uniform``: 23 random mantissa bits under the
    exponent of 1.0, minus 1, scaled to [minval, maxval). The bounds and
    their difference are rounded to float32 on the host, as JAX computes
    them, and enter the launches as scalars."""
    bits = random_bits(key, shape, device)
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = np.float32(maxval) - lo
    return torch.clamp(floats * float(span) + float(lo), min=float(lo))


def gumbel(key: torch.Tensor, shape: Sequence[int],
           device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """float32 ``jax.random.gumbel`` (its default "low" mode):
    -log(-log(u)), u uniform on [tiny, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(uniform(key, shape, tiny, 1.0, device)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)``: the argmax of
    logits + gumbel noise (float32 logits). ``key`` is one key, or one key
    per row, as in :func:`random_bits`. Returns int64 indices."""
    noise = gumbel(key, logits.shape, logits.device)
    return torch.argmax(noise + logits, dim=-1)
