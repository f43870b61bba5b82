"""Configurations and cells by name: the files under ``configs/`` and
``workloads/``, and the sizes the harness reads from them.

Nothing here imports the program: the reference and the roofline counts
take their sizes from these files alone.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent


def load_config(name: str) -> dict:
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def load_workload(name: str) -> dict:
    return json.loads((ROOT / "workloads" / f"{name}.json").read_text())


@dataclasses.dataclass(frozen=True)
class Dims:
    """The sizes of one configuration: the decoder's published keys and the
    tower's, and the projector between them."""

    D: int
    L: int
    H: int
    Hkv: int
    Dh: int
    F: int
    V: int
    gated: bool
    tied: bool
    act: str
    rope_theta: float
    rope_scaling: Optional[dict]
    eps: float
    eos: int
    # tower
    img: int
    patch: int
    Dv: int
    Lv: int
    Hv: int
    Fv: int
    eps_v: float

    @property
    def n_patches(self) -> int:
        return (self.img // self.patch) ** 2

    @property
    def tower_seq(self) -> int:  # patches + CLS
        return self.n_patches + 1

    # parameter counts ------------------------------------------------
    @property
    def layer_params(self) -> int:
        """One decoder layer: projections, MLP, norms (and qk-norm)."""
        D, H, Hkv, Dh, F = self.D, self.H, self.Hkv, self.Dh, self.F
        attn = D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D
        mlp = (3 if self.gated else 2) * D * F
        norms = 2 * D + 2 * Dh + (0 if self.gated else 2)  # qk-norm; xIELU's two alphas
        return attn + mlp + norms

    @property
    def decoder_params(self) -> int:
        """The published count: layers, final norm, embedding and (untied)
        head."""
        head = 0 if self.tied else self.V * self.D
        return self.L * self.layer_params + self.D + self.V * self.D + head

    @property
    def body_params(self) -> int:
        """What a token's forward multiplies by, the head and embedding left
        out: the layers and the final norm."""
        return self.L * self.layer_params + self.D

    @property
    def tower_layer_params(self) -> int:
        Dv, Fv = self.Dv, self.Fv
        return 4 * (Dv * Dv + Dv) + (Dv * Fv + Fv) + (Fv * Dv + Dv) + 4 * Dv

    @property
    def tower_params(self) -> int:
        Dv, P = self.Dv, self.patch
        return (P * P * 3 * Dv + self.tower_seq * Dv + Dv + 2 * Dv
                + self.Lv * self.tower_layer_params + 2 * Dv)

    @property
    def projector_params(self) -> int:
        Dv, D = self.Dv, self.D
        return Dv * Dv + Dv + Dv * D + D + D * D + D


def dims(cfg: dict) -> Dims:
    d, t = cfg["decoder"], cfg["tower"]
    mt = d.get("model_type", "llama")
    return Dims(
        D=d["hidden_size"], L=d["num_hidden_layers"], H=d["num_attention_heads"],
        Hkv=d.get("num_key_value_heads", d["num_attention_heads"]),
        Dh=d.get("head_dim") or d["hidden_size"] // d["num_attention_heads"],
        F=d["intermediate_size"], V=d["vocab_size"], gated=mt != "apertus",
        tied=bool(d.get("tie_word_embeddings", False)), act=d.get("hidden_act", "silu"),
        rope_theta=float(d.get("rope_theta", 10000.0)), rope_scaling=d.get("rope_scaling"),
        eps=float(d.get("rms_norm_eps", 1e-5)), eos=int(d.get("eos_token_id", 0)),
        img=t["image_size"], patch=t["patch_size"], Dv=t["hidden_size"],
        Lv=t["num_hidden_layers"], Hv=t["num_attention_heads"], Fv=t["intermediate_size"],
        eps_v=float(t.get("layer_norm_eps", 1e-5)))


def shrink(cfg: dict, **decoder_keys) -> dict:
    """A copy of ``cfg`` with some keys changed (tests and CPU rehearsals:
    never a measured cell). ``tower_*`` keys change the tower's."""
    out = json.loads(json.dumps(cfg))
    for k, v in decoder_keys.items():
        if k.startswith("tower_"):
            out["tower"][k[len("tower_"):]] = v
        else:
            out["decoder"][k] = v
    return out
