"""The ``dense`` decoder architecture: Llama-family layers, every one alike
(Apertus-8B, Qwen3-4B).

A layer is grouped-query attention (q, k, v, o; QK-norm over each head) and
an MLP of ``intermediate_size``: Qwen3's SiLU-gated one (gate, up, down) or
Apertus' gateless xIELU (up, down, the two alphas). Each layer attends the
whole causal sequence and every decode step reads every weight. The program
side is ``multimeditron_torch.models.llama`` (``LlamaConfig``,
``LlamaLayer``); the reference is ``reference/dense.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

import spec
import weights
from reference import dense as ref
from roofline import BF16, causal_pairs

# the decoder keys of a CPU rehearsal (rehearse.py): tiny widths, never a
# measured cell
TINY = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            head_dim=16, intermediate_size=96, vocab_size=512, eos_token_id=1)

PROGRAM_NAMES = {"q": "q_proj", "k": "k_proj", "v": "v_proj", "o": "o_proj",
                 "gate": "gate_proj", "up": "up_proj", "down": "down_proj"}


@dataclasses.dataclass(frozen=True)
class Dims(spec.Dims):
    H: int
    Hkv: int
    Dh: int
    F: int
    gated: bool
    act: str
    rope_theta: float
    rope_scaling: Optional[dict]

    # counts (roofline.py) ---------------------------------------------
    @property
    def layer_params(self) -> int:
        """One decoder layer: projections, MLP, norms (and qk-norm)."""
        D, H, Hkv, Dh, F = self.D, self.H, self.Hkv, self.Dh, self.F
        attn = D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D
        mlp = (3 if self.gated else 2) * D * F
        norms = 2 * D + 2 * Dh + (0 if self.gated else 2)  # qk-norm; xIELU's two alphas
        return attn + mlp + norms

    def kinds(self) -> List[Tuple[int, int]]:
        return [(0, self.L)]

    def params(self, i: int) -> int:
        return self.layer_params

    def active_params(self, i: int) -> int:
        return self.layer_params

    def pairs(self, i: int, n: int) -> int:
        return causal_pairs(n)

    def pair_flops(self, i: int) -> int:
        return 4 * self.H * self.Dh  # QK^T and PV

    def kv_bytes(self, i: int) -> int:
        return 2 * self.Hkv * self.Dh * BF16

    def decode_weight_bytes(self, counts: Optional[dict] = None) -> int:
        """Every decoder weight once, the lm_head included, the embedding
        table not."""
        return (self.body_params + self.V * self.D) * BF16

    # weights -----------------------------------------------------------
    def layer_blocks(self, i: int) -> List[Tuple[str, List[weights.Entry]]]:
        D, H, Hkv, Dh, F = self.D, self.H, self.Hkv, self.Dh, self.F
        m = weights.matrix
        entries = [m("q", H * Dh, D), m("k", Hkv * Dh, D), m("v", Hkv * Dh, D), m("o", D, H * Dh)]
        if self.gated:
            entries.append(m("gate", F, D))
        return [(f"decoder.layer.{i}", entries + [m("up", F, D), m("down", D, F)])]

    # the program -------------------------------------------------------
    def program_config(self, cfg: dict):
        from multimeditron_torch.models.llama import LlamaConfig

        return LlamaConfig.from_hf_dict(cfg["decoder"])

    def fill_layer(self, layer, W: Dict[str, torch.Tensor], i: int) -> None:
        for key, w in W.items():
            getattr(layer, PROGRAM_NAMES[key]).weight.copy_(w)
        for norm in ("input_norm", "post_attn_norm", "q_norm", "k_norm"):
            if hasattr(layer, norm):
                getattr(layer, norm).weight.fill_(1.0)
        if hasattr(layer, "xielu_alpha_p"):
            layer.xielu_alpha_p.fill_(ref.XIELU_ALPHA_P)
            layer.xielu_alpha_n.fill_(ref.XIELU_ALPHA_N)

    # the reference -----------------------------------------------------
    def ref_tables(self, n: int, device):
        return ref.rope_tables(self, n, device)

    def ref_layer(self, i: int, x: torch.Tensor, W: Dict[str, torch.Tensor], tables,
                  prec: str = "f32") -> torch.Tensor:
        cos, sin = tables
        return ref.decoder_layer(x, W, self, cos, sin, prec)


def dims(cfg: dict) -> Dims:
    d = cfg["decoder"]
    mt = d.get("model_type", "llama")
    return Dims(
        **spec.shared_dims(cfg), H=d["num_attention_heads"],
        Hkv=d.get("num_key_value_heads", d["num_attention_heads"]),
        Dh=d.get("head_dim") or d["hidden_size"] // d["num_attention_heads"],
        F=d["intermediate_size"], gated=mt != "apertus", act=d.get("hidden_act", "silu"),
        rope_theta=float(d.get("rope_theta", 10000.0)), rope_scaling=d.get("rope_scaling"))
