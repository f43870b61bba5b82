"""The decoder-architecture seam: a configuration names its architecture,
``arch/<name>.py``, and a new one needs new files only. A throwaway
architecture written outside the harness, dense in another block layout,
serves a correct tiny rehearsal."""

import torch

import rehearse
import spec
import weights

# dense with gate and up drawn as one matrix, in a block of its own
FLAT = '''
import dataclasses

import spec
import weights

dense = spec.load_module(spec.ROOT / "arch" / "dense.py")
TINY = dense.TINY


def _split(W):
    W = dict(W)
    gate, up = W.pop("gate_up").chunk(2)
    return dict(W, gate=gate, up=up)


@dataclasses.dataclass(frozen=True)
class Dims(dense.Dims):
    def layer_blocks(self, i):
        (tag, entries), = super().layer_blocks(i)
        attn = [e for e in entries if e[0] not in ("gate", "up", "down")]
        mlp = [weights.matrix("gate_up", 2 * self.F, self.D),
               weights.matrix("down", self.D, self.F)]
        return [(tag, attn), (f"decoder.mlp.{i}", mlp)]

    def fill_layer(self, layer, W, i):
        super().fill_layer(layer, _split(W), i)

    def ref_layer(self, i, x, W, tables, prec="f32"):
        return super().ref_layer(i, x, _split(W), tables, prec)


def dims(cfg):
    return Dims(**vars(dense.dims(cfg)))
'''
LONGTEXT = {"traffic": {"text_tokens": {"median": 40, "min": 20, "max": 70}}}
SEED = 3_000_000_041


def test_an_architecture_is_new_files_only(tmp_path, monkeypatch):
    cell = "qwen3-4b.chat-longtext"
    wl, cfg = rehearse.tiny(cell, LONGTEXT)
    dense = spec.dims(cfg)
    (tmp_path / "flat.py").write_text(FLAT)
    monkeypatch.setattr(spec, "ARCH_DIR", tmp_path)
    cfg["arch"] = "flat"
    d = spec.dims(cfg)
    assert type(d).__name__ == "Dims" and type(d) is not type(dense)
    flat_w = weights.decoder_layer(SEED, d, 0, "cpu")
    dense_w = weights.decoder_layer(SEED, dense, 0, "cpu")
    assert set(flat_w) == {"q", "k", "v", "o", "gate_up", "down"}
    assert torch.equal(flat_w["q"], dense_w["q"]) and not torch.equal(flat_w["down"],
                                                                      dense_w["down"])
    # the same counts: only the block layout differs
    assert (d.decoder_params, d.body_params) == (dense.decoder_params, dense.body_params)
    out, run = rehearse.run_tiny(cell, wl, cfg, SEED, seconds=1.0)
    assert out["correct"], (out, run.notes)
    assert out["attempted"] > 0 and out["failed"] == 0

