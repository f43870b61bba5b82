"""The reference over served requests: one causal pass over each prompt with
its served tokens, layer by layer, reading the logits at the positions that
produced those tokens.

``widest_gap`` is the number that decides ``correct`` in a serving cell:
over the sampled greedy requests and all their served positions, the largest
amount by which the served token's reference logit lies below the
reference's best logit there. A sound bf16 program serves each token within
its rounding of the best; a token altered where it is produced, or logits
computed from the wrong cache, land far below it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

import weights
from reference import model as ref
from spec import Dims


def logits_at(seed: int, d: Dims, seqs: List[Dict], device, prec: str = "f32",
              columns: Optional[List[torch.Tensor]] = None) -> List[Dict[str, torch.Tensor]]:
    """For each sequence (``ids`` (n,), ``image`` uint8 (S, S, 3) or None,
    ``image_at``, ``pos`` (k,)): the best logit, its token, and (with
    ``columns``, one (k, m) token matrix per sequence) the logits of those
    tokens, at each position in ``pos``."""
    with ref.no_tf32(), torch.no_grad():
        emb = weights.embed(seed, d, device)
        hs = [emb[s["ids"].to(device)].float() for s in seqs]
        del emb
        with_img = [i for i, s in enumerate(seqs) if s.get("image") is not None]
        if with_img:
            imgs = torch.stack([seqs[i]["image"] for i in with_img]).to(device)
            proj = ref.f32(weights.projector(seed, d, device))
            feats = ref.project(ref.tower(imgs, seed, d, prec), proj, prec)
            for j, i in enumerate(with_img):
                a = seqs[i]["image_at"]
                hs[i][a:a + feats.shape[1]] = feats[j]
            del feats
        n_max = max(h.shape[0] for h in hs)
        tables = d.ref_tables(n_max, device)
        for li in range(d.L):
            W = ref.f32(weights.decoder_layer(seed, d, li, device))
            hs = [d.ref_layer(li, h, W, tables, prec) for h in hs]
            del W
        head = weights.head(seed, d, device).float()
        out = []
        for i, (s, h) in enumerate(zip(seqs, hs)):
            x = ref.rms_norm(h[s["pos"].to(device)], d.eps)
            logits = ref.linear(x, head, prec=prec)
            top, arg = logits.max(dim=-1)
            row = {"top": top.cpu(), "argmax": arg.cpu()}
            if columns is not None:
                row["picked"] = logits.gather(1, columns[i].to(device).long()).cpu()
            out.append(row)
        return out


def served_seq(prompt_ids, image, image_at: int, served: List[int]) -> Dict:
    """A request as the reference reads it: the prompt and every served
    token but the last as its input, the positions from the prompt's last
    on as those read."""
    served = torch.as_tensor(served, dtype=torch.long)
    ids = torch.cat([torch.as_tensor(prompt_ids, dtype=torch.long), served[:-1]])
    n0 = len(prompt_ids)
    img = None if image is None else torch.as_tensor(image)
    return {"ids": ids, "image": img, "image_at": image_at,
            "pos": torch.arange(n0 - 1, n0 - 1 + len(served)), "served": served}


def widest_gap(seed: int, d: Dims, seqs: List[Dict], device) -> float:
    """The largest reference-logit gap of a served token below the best."""
    cols = [s["served"][:, None] for s in seqs]
    rows = logits_at(seed, d, seqs, device, "f32", cols)
    return max(float((r["top"] - r["picked"][:, 0]).max()) for r in rows)


def control_gaps(seed: int, d: Dims, seqs: List[Dict], device) -> Dict[str, float]:
    """The control, on the same prompts and served tokens: the widest gap of
    the tokens the fp8 reference puts first, beside the program's own."""
    low = logits_at(seed, d, seqs, device, "fp8")
    cols = [torch.stack([s["served"], r["argmax"]], dim=1) for s, r in zip(seqs, low)]
    rows = logits_at(seed, d, seqs, device, "f32", cols)
    gap = [(r["top"][:, None] - r["picked"]).amax(dim=0) for r in rows]
    return {"program": max(float(g[0]) for g in gap), "fp8": max(float(g[1]) for g in gap)}
