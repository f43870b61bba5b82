"""Seeded random weights, made on the device in one call per block.

A block is one of a decoder layer's blocks, as its architecture lays them
out (``arch/<name>.py``), a tower layer, the embedding, the head, the
tower's stem or the projector. Each block is one ``torch.randn`` of all its
matrices and biases together, from a generator seeded by (run seed, block
name), scaled piece by piece and cast to the served dtype. So any block can
be made again alone, on the same device, with the same values: the
reference builds the model layer by layer this way and never reads a
weight that the program holds.

Scales: N(0, 1/fan_in) for every matrix (the repo's own init), N(0, 1/D) for
the embedding and position tables, N(0, 0.02^2) for biases. Norms are ones
and zeros; other constants of a layer are its architecture's
(``arch/<name>.py``).
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, List, Tuple

import torch

from spec import Dims

Entry = Tuple[str, Tuple[int, ...], float]  # name, shape, std

BIAS_STD = 0.02


def block_seed(seed: int, tag: str) -> int:
    return (int(seed) * 0x9E3779B97F4A7C15 + zlib.crc32(tag.encode())) % (1 << 63)


def make_block(seed: int, tag: str, entries: List[Entry], device,
               dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """Every entry of one block, in ``dtype``: one float32 draw for all."""
    gen = torch.Generator(device=device).manual_seed(block_seed(seed, tag))
    total = sum(math.prod(shape) for _, shape, _ in entries)
    flat = torch.randn(total, generator=gen, dtype=torch.float32, device=device)
    out, at = {}, 0
    for name, shape, std in entries:
        n = math.prod(shape)
        out[name] = flat[at:at + n].view(shape).mul_(std).to(dtype)
        at += n
    return out


def matrix(name: str, out_f: int, in_f: int) -> Entry:
    return (name, (out_f, in_f), in_f ** -0.5)


def embed_entries(d: Dims) -> List[Entry]:
    return [("embed", (d.V, d.D), d.D ** -0.5)]


def head_entries(d: Dims) -> List[Entry]:
    return [] if d.tied else [("head", (d.V, d.D), d.D ** -0.5)]


def tower_stem_entries(d: Dims) -> List[Entry]:
    P = d.patch
    return [matrix("patch", d.Dv, P * P * 3), ("position", (d.tower_seq, d.Dv), d.Dv ** -0.5),
            ("cls", (d.Dv,), d.Dv ** -0.5)]


def tower_layer_entries(d: Dims) -> List[Entry]:
    Dv, Fv = d.Dv, d.Fv
    out: List[Entry] = []
    for name in ("q", "k", "v", "o"):
        out += [matrix(name, Dv, Dv), (name + "_b", (Dv,), BIAS_STD)]
    return out + [matrix("fc1", Fv, Dv), ("fc1_b", (Fv,), BIAS_STD),
                  matrix("fc2", Dv, Fv), ("fc2_b", (Dv,), BIAS_STD)]


def projector_entries(d: Dims) -> List[Entry]:
    Dv, D = d.Dv, d.D
    return [matrix("fc1", Dv, Dv), ("fc1_b", (Dv,), BIAS_STD),
            matrix("fc2", D, Dv), ("fc2_b", (D,), BIAS_STD),
            matrix("fc3", D, D), ("fc3_b", (D,), BIAS_STD)]


def decoder_layer(seed: int, d: Dims, i: int, device, dtype=torch.bfloat16):
    """Layer ``i``'s entries, from its architecture's blocks."""
    out = {}
    for tag, entries in d.layer_blocks(i):
        out.update(make_block(seed, tag, entries, device, dtype))
    return out


def embed(seed: int, d: Dims, device, dtype=torch.bfloat16) -> torch.Tensor:
    return make_block(seed, "decoder.embed", embed_entries(d), device, dtype)["embed"]


def head(seed: int, d: Dims, device, dtype=torch.bfloat16) -> torch.Tensor:
    """The output head: its own block, or the embedding when tied."""
    if d.tied:
        return embed(seed, d, device, dtype)
    return make_block(seed, "decoder.head", head_entries(d), device, dtype)["head"]


def tower_stem(seed: int, d: Dims, device, dtype=torch.bfloat16):
    return make_block(seed, "tower.stem", tower_stem_entries(d), device, dtype)


def tower_layer(seed: int, d: Dims, j: int, device, dtype=torch.bfloat16):
    return make_block(seed, f"tower.layer.{j}", tower_layer_entries(d), device, dtype)


def projector(seed: int, d: Dims, device, dtype=torch.bfloat16):
    return make_block(seed, "projector", projector_entries(d), device, dtype)
