"""Smoke-run every example end-to-end (VERDICT r4 item 6).

The examples are the only user-facing surface not otherwise imported by
the suite; round 3's fused-interp regression lived in exactly such a
gap.  Each example is executed in-process as ``__main__`` (so its
``main()`` fires) on the conftest CPU/8-virtual-device config — they
are written to be self-contained and small enough for CPU.
"""

import os
import runpy
import sys

import pytest

EXAMPLES_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"
)
EXAMPLES = sorted(
    f for f in os.listdir(EXAMPLES_DIR) if f.endswith(".py")
)


def test_examples_discovered():
    # Guard the parametrization itself: an empty list would silently
    # skip the whole file.
    assert len(EXAMPLES) >= 4


@pytest.mark.parametrize("example", EXAMPLES)
def test_example_runs(example, tmp_path, monkeypatch):
    # Any files an example writes (VTK exports etc.) land in tmp_path.
    monkeypatch.chdir(tmp_path)
    path = os.path.join(EXAMPLES_DIR, example)
    # run as from the command line, with no arguments
    monkeypatch.setattr(sys, "argv", [path])
    runpy.run_path(path, run_name="__main__")
