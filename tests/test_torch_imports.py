"""Import hygiene of the port: multimeditron_torch, its engine and
chip_smoke's module graph import with JAX, PIL, yaml and transformers
unavailable — the card's machine promises none of them."""

import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "PIL", "yaml", "transformers")

_PROBE = f"""
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of these now raises ImportError
import multimeditron_torch
import multimeditron_torch.convert
import multimeditron_torch.serve.engine
import chip_smoke
loaded = sorted(m for m in sys.modules if m.startswith("multimeditron_tpu"))
print(",".join(loaded))
"""


def test_port_imports_without_jax_pil_yaml_transformers():
    proc = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    # only the framework-free modules of the JAX package are reached
    loaded = set(proc.stdout.strip().split(","))
    assert loaded <= {"multimeditron_tpu", "multimeditron_tpu.registry",
                      "multimeditron_tpu.constants"}, loaded


def test_no_jax_import_in_port_sources():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|optax)\b", re.M)
    for path in list((ROOT / "multimeditron_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        assert not pattern.search(path.read_text()), path
