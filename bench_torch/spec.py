"""Configurations, cells and decoder architectures by name: the files under
``configs/``, ``workloads/`` and ``arch/``, and the sizes the harness reads
from them.

Nothing here imports the program: the reference and the roofline counts
take their sizes from these files alone.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH_DIR = ROOT / "arch"


def load_config(name: str) -> dict:
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def load_workload(name: str) -> dict:
    return json.loads((ROOT / "workloads" / f"{name}.json").read_text())


@dataclasses.dataclass(frozen=True)
class Dims:
    """The sizes of one configuration that every architecture shares: the
    decoder's residual width, depth, vocabulary, final norm and EOS, and the
    tower's and projector's.

    An architecture (``arch/<name>.py``, named by the configuration's
    ``"arch"``) subclasses this with its own sizes and provides, per layer
    index ``i``:

    - ``kinds()``: [(i, n)], one layer index for each kind of layer and how
      many layers are of that kind (the counts below are alike within one);
    - ``params(i)``: the layer's parameters; ``active_params(i)``: those a
      token multiplies by; ``pairs(i, n)``: the (query, key) pairs an n-token
      causal sequence attends in the layer; ``pair_flops(i)``: the attention's
      forward FLOPs per pair; ``kv_bytes(i)``: the K/V bytes one token holds;
    - ``decode_weight_bytes(counts)``: the weight bytes a decode step reads
      (``counts``: what the program reports of the step, such as the experts
      it touched; None where the step reads every weight);
    - ``layer_blocks(i)``: [(block tag, entries)] of the seeded weights
      (``weights.make_block``);
    - ``program_config(cfg)``: the program's decoder config, through its
      public entry points; ``fill_layer(layer, W, i)``: the program's layer
      ``i`` filled from the layer's blocks;
    - ``ref_tables(n, device)`` and ``ref_layer(i, x, W, tables, prec)``: the
      plain float32 reference layer over one sequence (``reference/``);

    and, at module level, ``dims(cfg)`` and ``TINY``, the decoder keys of its
    CPU rehearsals. The kernel bounds of K1, K2 and K4 (``roofline.py``) read
    the grouped-query heads ``H``, ``Hkv`` and ``Dh`` of an architecture that
    runs those kernels.
    """

    D: int
    L: int
    V: int
    tied: bool
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
    def decoder_params(self) -> int:
        """The published count: layers, final norm, embedding and (untied)
        head."""
        head = 0 if self.tied else self.V * self.D
        layers = sum(n * self.params(i) for i, n in self.kinds())
        return layers + self.D + self.V * self.D + head

    @property
    def body_params(self) -> int:
        """What a token's forward multiplies by, the head and embedding left
        out: the layers and the final norm."""
        return sum(n * self.active_params(i) for i, n in self.kinds()) + self.D

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


def shared_dims(cfg: dict) -> dict:
    """The fields of :class:`Dims` from a configuration: its architecture's
    ``dims`` adds its own."""
    d, t = cfg["decoder"], cfg["tower"]
    return dict(
        D=d["hidden_size"], L=d["num_hidden_layers"], V=d["vocab_size"],
        tied=bool(d.get("tie_word_embeddings", False)),
        eps=float(d.get("rms_norm_eps", 1e-5)), eos=int(d.get("eos_token_id", 0)),
        img=t["image_size"], patch=t["patch_size"], Dv=t["hidden_size"],
        Lv=t["num_hidden_layers"], Hv=t["num_attention_heads"], Fv=t["intermediate_size"],
        eps_v=float(t.get("layer_norm_eps", 1e-5)))


def load_module(path: Path):
    """A file of the harness loaded by its path, once."""
    path = Path(path).resolve()
    name = f"bench_{path.parent.name}_{path.stem}".replace("-", "_").replace(".", "_")
    mod = sys.modules.get(name)
    if mod is not None and Path(mod.__file__).resolve() == path:
        return mod
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    sys.modules[name] = mod  # dataclasses look their module up while it loads
    try:
        mod_spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[name]
        raise
    return mod


def architecture(name: str):
    """``arch/<name>.py``: the decoder architecture a configuration names."""
    path = ARCH_DIR / f"{name}.py"
    if not path.is_file():
        have = sorted(p.stem for p in ARCH_DIR.glob("*.py"))
        raise FileNotFoundError(f"no architecture {name!r}: {ARCH_DIR} holds {have}")
    return load_module(path)


def dims(cfg: dict) -> Dims:
    return architecture(cfg["arch"]).dims(cfg)


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
