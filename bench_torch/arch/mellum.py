"""The ``mellum`` decoder architecture: Mellum2-12B-A2.5B's layers.

Every layer is grouped-query attention (q, k, v, o; no QK-norm) and a routed
mixture of SiLU-gated experts (a router, then ``num_experts`` experts of
``moe_intermediate_size``, ``num_experts_per_tok`` a token, weights
renormalised). ``layer_types`` makes three of every four layers sliding-window
attention over ``sliding_window`` keys with default RoPE, the fourth full
attention with YaRN RoPE (``rope_parameters`` per kind). A decode step reads
the experts some token chose (``experts_touched``, counted by the program)
and, in a sliding layer, at most a window of K/V a slot.

The program side is ``multimeditron_torch.models.llama`` (``LlamaConfig``
with ``model_type: "mellum"``, ``LlamaLayer`` with ``models/moe.py``); the
reference is ``reference/mellum.py``. Here too are the grouped-expert
kernel's operations and bytes (``moe_flops``, ``moe_bytes``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

import spec
import weights
from reference import mellum as ref
from roofline import BF16, causal_pairs

SLIDING, FULL = "sliding_attention", "full_attention"
_ROPE = {FULL: {"rope_type": "yarn", "rope_theta": 500000, "factor": 16,
                "original_max_position_embeddings": 8192, "beta_fast": 32, "beta_slow": 1,
                "attention_factor": 1.2772588722239782},
         SLIDING: {"rope_type": "default", "rope_theta": 500000}}
# the decoder keys of a CPU rehearsal (rehearse.py): tiny widths, a window of
# 8 so that the rehearsals' sequences cross it, 8 experts, 2 a token; never
# a measured cell
TINY = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, moe_intermediate_size=32, num_experts=8, num_experts_per_tok=2,
            intermediate_size=96, vocab_size=512, sliding_window=8,
            layer_types=[SLIDING, SLIDING, SLIDING, FULL],
            mlp_layer_types=["sparse"] * 4, rope_parameters=_ROPE)

PROGRAM_NAMES = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "o_proj"}


@dataclasses.dataclass(frozen=True)
class Dims(spec.Dims):
    H: int
    Hkv: int
    Dh: int
    E: int
    K: int
    Fe: int
    window: int
    norm_topk: bool
    kinds_of: Tuple[str, ...]
    rope: dict

    # counts (roofline.py) ---------------------------------------------
    @property
    def attn_params(self) -> int:
        D, H, Hkv, Dh = self.D, self.H, self.Hkv, self.Dh
        return D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D

    @property
    def expert_params(self) -> int:
        """One expert: gate, up and down."""
        return 3 * self.D * self.Fe

    @property
    def shared_params(self) -> int:
        """What every token of a layer reads: attention, router, two norms."""
        return self.attn_params + self.E * self.D + 2 * self.D

    def kinds(self) -> List[Tuple[int, int]]:
        first = {}
        for i, kind in enumerate(self.kinds_of):
            first.setdefault(kind, [i, 0])[1] += 1
        return [tuple(v) for v in first.values()]

    def params(self, i: int) -> int:
        return self.shared_params + self.E * self.expert_params

    def active_params(self, i: int) -> int:
        return self.shared_params + self.K * self.expert_params

    def layer_window(self, i: int) -> int:
        return self.window if self.kinds_of[i] == SLIDING else 0

    def pairs(self, i: int, n: int) -> int:
        """Causal pairs, a sliding layer's limited to the window's keys."""
        W = self.layer_window(i)
        if not W or n <= W:
            return causal_pairs(n)
        return causal_pairs(W) + (n - W) * W

    def pair_flops(self, i: int) -> int:
        return 4 * self.H * self.Dh

    def kv_bytes(self, i: int) -> int:
        return 2 * self.Hkv * self.Dh * BF16

    def decode_weight_bytes(self, counts: Optional[dict] = None) -> int:
        """Every weight but the experts' and the embedding, the lm_head
        included, plus the experts read: ``counts["experts_touched"]``, the
        experts with a token summed over the layers (a step's, or a mean
        over steps), else every expert of every layer."""
        touched = self.L * self.E if counts is None else counts["experts_touched"]
        dense = self.L * self.shared_params + self.D + self.V * self.D
        return int(round((dense + touched * self.expert_params) * BF16))

    # the grouped-expert kernel (readers_moe.py) --------------------------
    def moe_flops(self, assignments: float) -> float:
        """Gate, up and down over each (token, expert) assignment."""
        return 2.0 * self.expert_params * assignments

    def moe_bytes(self, touched: float, assignments: float) -> float:
        """The touched experts' weights read once, each token's row read and
        its sum written once (bf16)."""
        return (touched * self.expert_params + 2.0 * self.D * assignments / self.K) * BF16

    # weights -----------------------------------------------------------
    def layer_blocks(self, i: int) -> List[Tuple[str, List[weights.Entry]]]:
        D, H, Hkv, Dh, E, Fe = self.D, self.H, self.Hkv, self.Dh, self.E, self.Fe
        m = weights.matrix
        attn = [m("q", H * Dh, D), m("k", Hkv * Dh, D), m("v", Hkv * Dh, D), m("o", D, H * Dh),
                m("router", E, D)]
        experts = [("gate", (E, Fe, D), D ** -0.5), ("up", (E, Fe, D), D ** -0.5),
                   ("down", (E, D, Fe), Fe ** -0.5)]
        return [(f"decoder.layer.{i}", attn), (f"decoder.experts.{i}", experts)]

    # the program -------------------------------------------------------
    def program_config(self, cfg: dict):
        from multimeditron_torch.models.llama import LlamaConfig

        return LlamaConfig.from_hf_dict(cfg["decoder"])

    def fill_layer(self, layer, W: Dict[str, torch.Tensor], i: int) -> None:
        for key, name in PROGRAM_NAMES.items():
            getattr(layer, name).weight.copy_(W[key])
        layer.moe.router.weight.copy_(W["router"])
        layer.moe.w_gate.copy_(W["gate"])
        layer.moe.w_up.copy_(W["up"])
        layer.moe.w_down.copy_(W["down"])
        layer.input_norm.weight.fill_(1.0)
        layer.post_attn_norm.weight.fill_(1.0)

    # the reference -----------------------------------------------------
    def ref_tables(self, n: int, device):
        return ref.rope_tables(self, n, device)

    def ref_layer(self, i: int, x: torch.Tensor, W: Dict[str, torch.Tensor], tables,
                  prec: str = "f32") -> torch.Tensor:
        return ref.decoder_layer(i, x, W, self, tables, prec)


def dims(cfg: dict) -> Dims:
    d = cfg["decoder"]
    return Dims(
        **spec.shared_dims(cfg), H=d["num_attention_heads"], Hkv=d["num_key_value_heads"],
        Dh=d["head_dim"], E=d["num_experts"], K=d["num_experts_per_tok"],
        Fe=d["moe_intermediate_size"], window=int(d["sliding_window"]),
        norm_topk=bool(d.get("norm_topk_prob", True)), kinds_of=tuple(d["layer_types"]),
        rope=d["rope_parameters"])
