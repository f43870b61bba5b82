import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))
sys.path.insert(1, str(HERE.parent.parent))


import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _tracer_off():
    """A traced rehearsal turns the program's tracer on (``devtrace.prime``):
    the next test starts with it off."""
    yield
    from multimeditron_torch.profiling import tracer

    tracer.disable()
