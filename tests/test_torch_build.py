"""The kernel build's ptxas report, read on the CPU from a sample of what
``nvcc -Xptxas -v`` prints (no compiler is needed)."""

from multimeditron_torch import _build

SAMPLE = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z6kernelILi0EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi0EEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6kernelILi3EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z6kernelILi3EEvv
    8 bytes stack frame, 60 bytes spill stores, 88 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]
ptxas warning : (C7512) a made-up note for the parser
"""


def test_ptxas_report_reads_registers_and_spills(monkeypatch):
    monkeypatch.setattr(_build, "build_logs", {"k.cu": SAMPLE})
    report = _build.ptxas_report("k.cu")
    assert report["kernels"] == [
        dict(entry="_Z6kernelILi0EEvv", registers=168, spill_stores=0, spill_loads=0),
        dict(entry="_Z6kernelILi3EEvv", registers=168, spill_stores=60, spill_loads=88)]
    assert report["warnings"] == ["ptxas warning : (C7512) a made-up note for the parser"]
    monkeypatch.setitem(_build.build_logs, "other.cu", "")
    assert _build.ptxas_report("other.cu") == dict(kernels=[], warnings=[])
