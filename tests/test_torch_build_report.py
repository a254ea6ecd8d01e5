"""ptxas's report of a CUDA build, read back whoever built the library.

``ops/_build.load_library`` writes ptxas's ``-v`` output beside each
library it builds, and ``build_report`` returns it both in the process
that built the library and in one that finds it built already (a second
run of a script in the same checkout).  ``nvcc`` is a stand-in script
here, so this runs on the CPU.
"""

import os
import stat

import pytest

from chainermn_tpu_torch.ops import _build

REPORT = ("ptxas info    : Compiling entry function '_Z6kernelv' for "
          "'sm_90a'\nptxas info    : Used 42 registers\n")


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """A checkout whose ``csrc`` holds ``demo.cu``, an ``nvcc`` that
    writes REPORT to stderr, an empty library and one line to ``calls``,
    and a ``ctypes.CDLL`` that returns the path it was given."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "demo.cu").write_text("__global__ void kernel() {}\n")
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        f"echo built >> '{calls}'\n"
        'while [ "$#" -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then out="$2"; fi; shift\n'
        "done\n"
        f"printf '%s' \"{REPORT}\" >&2\n"
        ': > "$out"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", str)
    return calls


def _builds(calls):
    return len(calls.read_text().splitlines()) if calls.exists() else 0


def test_report_of_a_fresh_build(fake_build):
    assert _build.build_report("demo") == REPORT
    assert _build.library_path("demo").exists()
    assert _build.report_path("demo").read_text() == REPORT
    assert _builds(fake_build) == 1
    # only the library and its report are left in the build directory
    assert sorted(p.name for p in _build.BUILD.iterdir()) == sorted(
        [_build.library_path("demo").name, _build.report_path("demo").name,
         "demo.lock"])


def test_report_of_a_library_built_before(fake_build, monkeypatch):
    """A later process (nothing loaded yet) finds the library there:
    no build, the same report."""
    _build.load_library("demo")
    monkeypatch.setattr(_build, "_LIBS", {})
    assert _build.build_report("demo") == REPORT
    assert _builds(fake_build) == 1


def test_a_library_without_its_report_is_named(fake_build):
    out = _build.library_path("demo")
    out.parent.mkdir(parents=True)
    out.write_bytes(b"")
    with pytest.raises(RuntimeError, match="no build report"):
        _build.build_report("demo")
    assert _builds(fake_build) == 0


def test_the_report_follows_the_source(fake_build, monkeypatch):
    """An edited source, in a later process, is a new library with its
    own report."""
    first = _build.report_path("demo")
    _build.build_report("demo")
    (_build.CSRC / "demo.cu").write_text("__global__ void other() {}\n")
    monkeypatch.setattr(_build, "_LIBS", {})
    assert _build.report_path("demo") != first
    assert _build.build_report("demo") == REPORT
    assert _builds(fake_build) == 2


def test_ptxas_verbose_is_part_of_every_build():
    flags = _build.NVCC_FLAGS
    assert flags[flags.index("-Xptxas") + 1] == "-v"
    assert _build.report_path("cast_scale").name == (
        _build.library_path("cast_scale").name[:-len(".so")] + ".ptxas.txt")
    assert os.path.dirname(_build.report_path("cast_scale")) == str(
        _build.BUILD)
