"""The one traffic generator: every cell's requests or batches, from its
workload file's ``traffic`` parameters and the run's seed.

Sizes and gaps are drawn by stratified quantiles of their stated
distribution and put in an order drawn from the seed, so every seed gets the
same set of sizes and arrivals in another order, and the work of a run does
not change with its seed. Token ids and pixels are drawn from the seed.
Nothing here reads the clock or touches the device.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Dict, List, Optional

import numpy as np

IGNORE = -100


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def quantiles(spec: dict, n: int) -> np.ndarray:
    """n stratified draws (ints) of a {"dist": "lognormal", "median",
    "sigma", "min", "max"} or {"dist": "const", "value"} length."""
    if spec["dist"] == "const":
        return np.full(n, int(spec["value"]), np.int64)
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    x = spec["median"] * np.exp(spec["sigma"] * z)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def exp_gaps(rate: float, n: int) -> np.ndarray:
    """n stratified exponential gaps of mean 1/rate (Poisson arrivals)."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


@dataclasses.dataclass
class Prompt:
    """One request's prompt: a B=1 collated batch as the engine takes it."""

    index: int
    ids: np.ndarray          # (n,) int32, image positions included
    image: Optional[np.ndarray]  # (S, S, 3) uint8
    image_at: int
    n_emb: int
    out_tokens: int
    greedy: bool

    @property
    def length(self) -> int:
        return len(self.ids)

    def batch(self) -> Dict:
        ids = self.ids[None].astype(np.int32)
        b = {"input_ids": ids, "attention_mask": np.ones_like(ids)}
        if self.image is not None:
            b["mm_inputs"] = {"image": {
                "values": self.image[None],
                "batch_idx": np.zeros((self.n_emb,), np.int32),
                "token_pos": np.arange(self.image_at, self.image_at + self.n_emb,
                                       dtype=np.int32)}}
        return b


def prompts(tr: dict, n: int, seed: int, vocab: int, image_size: int, n_emb: int,
            out_tokens: Optional[np.ndarray] = None, text: Optional[np.ndarray] = None,
            first: int = 0) -> List[Prompt]:
    """n prompts: optional image (``images_per_request`` 0 or 1) at
    ``image_at`` and text of ``text_tokens`` length (or ``text``); every
    ``greedy_every``-th request, counted from ``first``, decodes greedily (the
    ones the check compares)."""
    r = rng(seed, 1 + first)
    order = r.permutation(n)
    if text is None:
        text = quantiles(tr["text_tokens"], n)[order]
    if out_tokens is None:
        # each text length keeps one output length whatever the seed: the
        # pairs are fixed, their order is the seed's
        pairing = rng(0, n).permutation(n)
        out_tokens = quantiles(tr["output_tokens"], n)[pairing][order]
    with_img = tr.get("images_per_request", 0) > 0
    at = tr.get("image_at", 0)
    k = tr.get("greedy_every", 0)
    res = []
    for i in range(n):
        length = int(text[i]) + (n_emb if with_img else 0)
        ids = r.integers(2, vocab, length).astype(np.int32)
        img = (r.integers(0, 256, (image_size, image_size, 3), dtype=np.uint8)
               if with_img else None)
        j = first + i
        res.append(Prompt(j, ids, img, at, n_emb, int(out_tokens[i]), bool(k and j % k == 0)))
    return res


def open_schedule(tr: dict, seconds: float, seed: int, vocab: int, image_size: int,
                  n_emb: int):
    """Open-loop arrivals at ``rate_per_s`` over the ramp, the window and the
    drain: (offsets from the schedule's start, prompts). Each of the three
    stretches holds its own stratified set of gaps and sizes, its gaps summing
    to its length, so the window holds the same requests for every seed."""
    rate = tr["rate_per_s"]
    offsets, out, t0 = [], [], 0.0
    for seg, length in enumerate((tr["ramp_s"], seconds, tr["drain_s"])):
        n = max(1, int(round(rate * length)))
        r = rng(seed, 10 + seg)
        gaps = exp_gaps(rate, n)[r.permutation(n)]
        gaps = gaps * (length / gaps.sum())
        # from exactly t0 on, all before t0 + length
        offsets.append(t0 + np.concatenate([[0.0], np.cumsum(gaps)[:-1]]))
        out += prompts(tr, n, seed, vocab, image_size, n_emb, first=len(out))
        t0 += length
    return np.concatenate(offsets), out


def group_prompts(tr: dict, n_groups: int, seed: int, vocab: int, image_size: int,
                  n_emb: int) -> List[Prompt]:
    """Prompts of forked groups; every group's budget is ``max_new_tokens``."""
    budget = np.full(n_groups, tr["max_new_tokens"], np.int64)
    return prompts(tr, n_groups, seed, vocab, image_size, n_emb, out_tokens=budget)


def train_batches(tr: dict, n: int, seed: int, vocab: int, image_size: int,
                  n_emb: int) -> List[Dict]:
    """n collated ALIGNMENT batches of ``batch_size`` rows, in the collator's
    layout: a user turn of ``image_at`` tokens, one image and ``user_gap``
    tokens (labels ignored), then the assistant's tokens (labelled); right
    padding to a multiple of ``seq_multiple``; ``image_budget`` image slots,
    the unused ones zero and dropped by the splice. Each run of ``block``
    batches holds the same batches of sample lengths in a seeded order."""
    B, K = tr["batch_size"], tr["block"]
    r = rng(seed, 3)
    # K batches of B stratified lengths, grouped once whatever the seed (the
    # grouping sets each batch's padding); every block of K batches holds
    # them all, in an order drawn from the seed
    block = quantiles(tr["sample_tokens"], K * B)[rng(0, K * B).permutation(K * B)]
    block = block.reshape(K, B)
    lens = np.concatenate([block[r.permutation(K)] for _ in range(-(-n // K))])[:n]
    at, gap, slots, m = tr["image_at"], tr["user_gap"], tr["image_budget"], tr["seq_multiple"]
    user = at + n_emb + gap
    out = []
    for valid in lens:
        S = min(int(math.ceil(valid.max() / m) * m), tr["max_seq"])
        mask = (np.arange(S)[None, :] < valid[:, None]).astype(np.int32)
        ids = np.where(mask == 1, r.integers(2, vocab, (B, S)), 0).astype(np.int32)
        labels = np.where(mask == 1, ids, IGNORE).astype(np.int32)
        labels[:, :user] = IGNORE
        values = np.zeros((slots, image_size, image_size, 3), np.uint8)
        values[:B] = r.integers(0, 256, (B, image_size, image_size, 3), dtype=np.uint8)
        batch_idx = np.full((slots * n_emb,), B, np.int32)
        token_pos = np.zeros((slots * n_emb,), np.int32)
        batch_idx[:B * n_emb] = np.repeat(np.arange(B, dtype=np.int32), n_emb)
        token_pos[:B * n_emb] = np.tile(np.arange(at, at + n_emb, dtype=np.int32), B)
        out.append({
            "input_ids": ids, "attention_mask": mask, "labels": labels,
            "position_ids": np.where(mask == 1, np.cumsum(mask, -1) - 1, 0).astype(np.int32),
            "mm_inputs": {"image": {"values": values, "batch_idx": batch_idx,
                                    "token_pos": token_pos}}})
    return out
