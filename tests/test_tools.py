"""Tools-script smoke: every tool imports and parses --help without a GPU.

Protects tools/ (microbench, parity, frame profiler, sampler viz) from
bitrot against API changes — they are the measurement record's provenance
(PERF.md / PARITY.md numbers all come from these)."""

import os
import subprocess
import sys

import pytest

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


@pytest.mark.parametrize("script", ["kernel_bench.py", "parity.py"])
def test_tool_help_runs(script):
    out = subprocess.run(
        [sys.executable, os.path.join(TOOLS, script), "--help"],
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "usage" in out.stdout.lower()


def test_frame_profile_compiles():
    import ast
    with open(os.path.join(TOOLS, "frame_profile.py")) as f:
        ast.parse(f.read())
