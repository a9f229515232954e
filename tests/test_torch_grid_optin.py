"""The port's opt-in paths over a clusters axis against the JAX engine.

The chain of tests/test_torch_grid_chain.py (``_run_chain``) on a (2, 2)
mesh of logical CPU entries with each opt-in switch (three-stream
survivors, f16 score planes, the dense fetch, the dense solve): the
port on the grid equals the unmeshed port and the JAX engine on a
(2, 2) mesh with the same switch (the JAX engine's environment switch
where it reads one there) at every tick: results, counters and the
flight recorder's per-key placements and reason counts.
"""

from __future__ import annotations

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from test_torch_grid_chain import _run_chain  # noqa: E402


@pytest.mark.parametrize("switches", [
    {"survivor_unified": False}, {"score_f16": True}, {"fetch_format": "dense"},
    {"narrow": False},
], ids=["three-stream", "f16", "dense-fetch", "dense-solve"])
def test_optin_paths_on_a_grid(switches, monkeypatch):
    _run_chain((2, 2), switches, monkeypatch)
