"""The kernel build on the CPU (no compiler is needed): the ptxas report,
read from a sample of what ``nvcc -Xptxas -v`` prints, and the ctypes
signature table against the C entry points of ``csrc/*.cu``."""

import ctypes
import re

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


def _c_entries() -> dict:
    """Every ``extern "C"`` function of ``csrc/*.cu``: name -> (return type,
    [argument kinds]), each argument ``P`` (a pointer), ``I`` (int) or ``F``
    (float)."""
    entries = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        text = src.read_text()
        for ret, name, args in re.findall(r'extern "C" (int|const char\*) (\w+)\(([^)]*)\)', text):
            kinds = []
            for arg in filter(None, (a.strip() for a in args.split(","))):
                kinds.append("P" if "*" in arg else {"int": "I", "float": "F"}[arg.split()[0]])
            assert name not in entries, f"{name} is defined twice"
            entries[name] = (ret, kinds)
    return entries


def test_every_c_entry_has_a_matching_ctypes_row():
    # a stale or miscounted row would pass the wrong arguments without an error
    codes = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_float: "F"}
    entries = _c_entries()
    rows = {name: [codes[t] for t in types] for name, types in _build.SIGNATURES.items()}
    defined = {name: kinds for name, (ret, kinds) in entries.items() if ret == "int"}
    assert rows == defined
    # the one entry that returns no error code, bound apart in library()
    assert {name for name, (ret, _) in entries.items() if ret != "int"} == {"mmt_error_string"}


def test_c_entry_parser_reads_names_and_kinds(monkeypatch, tmp_path):
    (tmp_path / "a.cu").write_text(
        'extern "C" int mmt_x(const void* a, void* b, int M,\n'
        '                     float s, void* stream) {\n  return 0;\n}\n'
        'extern "C" int mmt_n() { return 3; }\n'
        'extern "C" const char* mmt_error_string(int code) { return ""; }\n')
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _c_entries() == {"mmt_x": ("int", ["P", "P", "I", "F", "P"]), "mmt_n": ("int", []),
                            "mmt_error_string": ("const char*", ["I"])}
