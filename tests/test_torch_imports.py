"""Import hygiene of the port: multimeditron_torch, its engine, its trainer
and chip_smoke's module graph import with JAX, PIL, yaml and transformers
unavailable — the card's machine promises none of them — and load no module
of the JAX package. Modules build on the card unless asked for the CPU."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

from multimeditron_torch import default_device
from multimeditron_torch.models import multimodal as tm
from multimeditron_torch.models.llama import Llama
from multimeditron_torch.models.projector import MLPProjector
from multimeditron_torch.profiling import ThroughputMeter, device_peak_flops
from tests.test_multimodal import tiny_mm_config

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "PIL", "yaml", "transformers", "click")
PORT_SOURCES = list((ROOT / "multimeditron_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]

_PROBE = f"""
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of these now raises ImportError
import multimeditron_torch
import multimeditron_torch.convert
import multimeditron_torch.serve.engine
import multimeditron_torch.serve.prng
import multimeditron_torch.ops.flash_attention
import multimeditron_torch.ops.vit_int8_fused
import multimeditron_torch.ops.wo_matmul
import multimeditron_torch.models.llama_quant
import multimeditron_torch.models.vit_quant
import multimeditron_torch.models.projector
import multimeditron_torch.modalities.image_clip
import multimeditron_torch.profiling
import multimeditron_torch.train.checkpoint
import multimeditron_torch.train.data
import multimeditron_torch.train.trainer
import multimeditron_torch.utils.jsonl
import chip_smoke
loaded = sorted(m for m in sys.modules if m.startswith("multimeditron_tpu"))
print(",".join(loaded))
"""


def test_port_imports_without_jax_pil_yaml_transformers():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # no module of the JAX package is reached, not even a framework-free one
    loaded = {m for m in proc.stdout.strip().split(",") if m}
    assert loaded == set(), loaded


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b", re.M)
    for path in PORT_SOURCES:
        assert not pattern.search(path.read_text()), path


def test_no_jax_package_import_in_port_sources():
    pattern = re.compile(r"^\s*(import|from)\s+multimeditron_tpu\b", re.M)
    for path in PORT_SOURCES:
        assert not pattern.search(path.read_text()), path


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_modules_build_on_the_cpu_only_when_asked(monkeypatch):
    _no_cuda(monkeypatch)
    cfg = tm.MultimodalConfig.from_dict(tiny_mm_config().to_dict())
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tm.MultimodalModel(cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Llama(cfg.llm)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MLPProjector(8, 16)
    model = tm.MultimodalModel(cfg, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


def test_default_device_and_throughput_meter(monkeypatch):
    assert default_device("cpu") == torch.device("cpu")
    assert device_peak_flops("cpu") > 0
    assert ThroughputMeter(num_params=10, device="cpu").update(5)["mfu"] > 0
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        default_device()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ThroughputMeter(num_params=10)
