"""The reference over the first training steps of an ALIGNMENT run.

Each step: the tower (frozen) and the projector (trained) over the batch's
images, the splice, the decoder's causal forward over each row's valid
tokens, the mean next-token cross entropy over every labelled position of the
batch, and the gradient back to the projector through every decoder layer,
layer by layer (each layer's forward is made again with its weights, so only
the layers' inputs are kept). Then AdamW as the repo's trainer states it
(optax's ``clip_by_global_norm``, ``adamw`` with bias correction and
decoupled weight decay, ``warmup_cosine_decay_schedule``), the update
computed in float32 and the parameters and both moments kept in the
parameters' dtype, bf16, as optax keeps them.

``prec="fp8"`` runs the same steps with every linear layer's inputs rounded
to e4m3 (the control).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

import weights
from reference import model as ref
from spec import Dims

LEAVES = ("fc1", "fc1_b", "fc2", "fc2_b", "fc3", "fc3_b")
ADAM_EPS = 1e-8


def lr_at(t: dict, count: int) -> float:
    """optax.warmup_cosine_decay_schedule(0 or peak, peak, warmup, total,
    min_lr) at update ``count``."""
    peak, warmup = t["learning_rate"], t.get("warmup_steps", 0)
    if count < warmup:
        return peak * count / warmup
    decay = max(t["total_steps"], 1) - warmup
    alpha = t["min_lr"] / peak
    k = min(count - warmup, decay)
    return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * k / decay)) + alpha)


def _rows(batch: dict):
    """Per row: valid ids, labels, and the (slot, start) of its images."""
    mask = np.asarray(batch["attention_mask"])
    B = mask.shape[0]
    pack = batch["mm_inputs"]["image"]
    bi, tp = np.asarray(pack["batch_idx"]), np.asarray(pack["token_pos"])
    n_emb = len(bi) // len(pack["values"])
    images: List[List[tuple]] = [[] for _ in range(B)]
    for slot in range(len(pack["values"])):
        b = int(bi[slot * n_emb])
        if b < B:
            images[b].append((slot, int(tp[slot * n_emb])))
    out = []
    for r in range(B):
        n = int(mask[r].sum())
        out.append((np.asarray(batch["input_ids"])[r, :n], np.asarray(batch["labels"])[r, :n],
                    images[r]))
    return out


def loss_and_grads(seed: int, d: Dims, P: Dict[str, torch.Tensor], batch: dict, device,
                   prec: str = "f32", block: int = 1024):
    """(loss, {leaf: gradient}) at projector parameters ``P`` (float32)."""
    rows = _rows(batch)
    values = torch.as_tensor(np.asarray(batch["mm_inputs"]["image"]["values"]))
    used = sorted({slot for _, _, imgs in rows for slot, _ in imgs})
    with torch.no_grad():
        feats = ref.tower(values[used].to(device), seed, d, prec)
        emb = weights.embed(seed, d, device)
        hs = [emb[torch.as_tensor(ids, dtype=torch.long, device=device)].float()
              for ids, _, _ in rows]
        del emb
    Pg = {k: v.detach().clone().requires_grad_(True) for k, v in P.items()}
    proj = ref.project(feats, Pg, prec)
    slot_of = {slot: j for j, slot in enumerate(used)}
    with torch.no_grad():
        for h, (_, _, imgs) in zip(hs, rows):
            for slot, start in imgs:
                h[start:start + proj.shape[1]] = proj[slot_of[slot]]
    count = sum(int((lab[1:] != -100).sum()) for _, lab, _ in rows)
    n_max = max(h.shape[0] for h in hs)
    tables = d.ref_tables(n_max, device)
    saved = []
    with torch.no_grad():
        for li in range(d.L):
            saved.append(hs)
            W = ref.f32(weights.decoder_layer(seed, d, li, device))
            hs = [d.ref_layer(li, h, W, tables, prec) for h in hs]
    head = weights.head(seed, d, device).float()
    loss, grads = 0.0, []
    for h, (_, lab, _) in zip(hs, rows):
        tgt = torch.as_tensor(lab[1:], dtype=torch.long, device=device)
        g = torch.zeros_like(h)
        for a in range(0, h.shape[0] - 1, block):
            x = h[a:min(a + block, h.shape[0] - 1)].detach().requires_grad_(True)
            t = tgt[a:a + x.shape[0]]
            logits = ref.linear(ref.rms_norm(x, d.eps), head, prec=prec)
            valid = t != -100
            nll = torch.logsumexp(logits, -1) - logits.gather(1, t.clamp(min=0)[:, None])[:, 0]
            part = (nll * valid).sum() / count
            part.backward()
            loss += float(part.detach())
            g[a:a + x.shape[0]] = x.grad
        grads.append(g)
    del head
    for li in reversed(range(d.L)):
        W = ref.f32(weights.decoder_layer(seed, d, li, device))
        new = []
        for x0, g in zip(saved[li], grads):
            x = x0.detach().requires_grad_(True)
            d.ref_layer(li, x, W, tables, prec).backward(g)
            new.append(x.grad)
        grads = new
        saved[li] = None
    # the splice: the embedding rows at image positions came from ``proj``
    total = 0.0
    for g, (_, _, imgs) in zip(grads, rows):
        for slot, start in imgs:
            total = total + (proj[slot_of[slot]] * g[start:start + proj.shape[1]]).sum()
    total.backward()
    return loss, {k: Pg[k].grad.detach() for k in LEAVES}


def run_steps(seed: int, d: Dims, batches: List[dict], tcfg: dict, device,
              prec: str = "f32") -> dict:
    """The first len(batches) AdamW steps from the seed's projector:
    each step's loss, the first step's clipped gradient norm by leaf, and
    the norm of each leaf's change over all the steps."""
    with ref.no_tf32():
        P0 = weights.projector(seed, d, device)  # bf16, the stated dtype
        P = {k: P0[k].clone() for k in LEAVES}
        mu = {k: torch.zeros_like(P[k]) for k in LEAVES}
        nu = {k: torch.zeros_like(P[k]) for k in LEAVES}
        b1, b2, wd = tcfg["b1"], tcfg["b2"], tcfg["weight_decay"]
        losses, grad1 = [], {}
        for step, batch in enumerate(batches):
            loss, g = loss_and_grads(seed, d, {k: v.float() for k, v in P.items()}, batch,
                                     device, prec)
            losses.append(loss)
            norm = math.sqrt(sum(float(v.pow(2).sum()) for v in g.values()))
            if norm >= tcfg["max_grad_norm"]:
                g = {k: v / norm * tcfg["max_grad_norm"] for k, v in g.items()}
            if step == 0:
                grad1 = {k: float(v.norm()) for k, v in g.items()}
            c = step + 1
            lr = lr_at(tcfg, step)
            for k in LEAVES:
                m = (1 - b1) * g[k] + b1 * mu[k].float()
                v2 = (1 - b2) * g[k] * g[k] + b2 * nu[k].float()
                upd = (m / (1 - b1 ** c)) / (torch.sqrt(v2 / (1 - b2 ** c)) + ADAM_EPS)
                p = P[k].float()
                P[k] = (p - lr * (upd + wd * p)).to(P[k].dtype)
                mu[k], nu[k] = m.to(mu[k].dtype), v2.to(nu[k].dtype)
        delta = {k: float((P[k].float() - P0[k].float()).norm()) for k in LEAVES}
        return {"losses": losses, "grad1": grad1, "delta": delta}
