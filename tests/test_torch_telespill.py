"""The port's telemetry spill (``runtime/telespill.py``) against the JAX one.

The cases of ``tests/test_telespill.py`` that reach no HTTP transport
(the segment durability cases, the spiller's span and timeline deltas,
and the trace cases the spill relies on that need no traceparent
header: explicit parents and the Chrome export's wall-clock anchor) run
twice, over the JAX package
and with the test module's globals and its lazy ``timeline`` import
pointed at the port's.  A ``KT_*`` ``setenv`` becomes the port's
constant (``ENV_CONSTANTS``).  Each run gets its own directory; what the
two leave there is equal: the segment and quarantine files (the process
id masked in their names) and every record, with the clocks, process
and span ids masked.  The SIGKILL case runs its child on the port.
"""

from __future__ import annotations

import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import pytest

import test_telespill as TS
from test_torch_dispatch import ConstantsPatch
from test_torch_sync import method_cases, point_at_port

from kubeadmiral_tpu_torch.runtime import telespill, timeline
from kubeadmiral_tpu_torch.runtime.telespill import load_dir

ENV_CONSTANTS = {
    "KT_SPILL": (telespill, "ENABLED", lambda v: v not in ("0", "false", "no")),
}

VOLATILE = {"wall", "mono", "wall_epoch", "pid", "start", "end", "tid", "thread_name",
            "span_id", "parent_id", "trace_id"}


def _masked(x):
    if isinstance(x, dict):
        return {k: _masked(v) for k, v in x.items() if k not in VOLATILE}
    if isinstance(x, list):
        return [_masked(v) for v in x]
    return x


def _left_behind(directory: Path):
    files, records = [], []
    for path in sorted(directory.rglob("*")):
        if path.is_file():
            files.append(re.sub(r"-\d+-(\d{6})", r"-PID-\1", str(path.relative_to(directory))))
    for sub in sorted({p.parent for p in directory.rglob("*.ktspill")}):
        records.append(_masked(load_dir(str(sub))))
    return files, records


def run_case(monkeypatch, tmp: Path, cls, name, port: bool):
    tmp.mkdir()
    with monkeypatch.context() as mp:
        if port:
            point_at_port(mp, TS)
            mp.setitem(sys.modules, "kubeadmiral_tpu.runtime.timeline", timeline)
        obj = cls()
        method = getattr(obj, name)
        params = method.__code__.co_varnames[1: method.__code__.co_argcount]
        kw = {}
        if "tmp_path" in params:
            kw["tmp_path"] = tmp
        if "monkeypatch" in params:
            kw["monkeypatch"] = ConstantsPatch(mp, ENV_CONSTANTS) if port else mp
        method(**kw)
    return _left_behind(tmp)


CASES = [
    (cls, name)
    for cls, name in method_cases(TS.TestSegmentDurability, TS.TestTelemetrySpiller)
    if name != "test_sigkill_mid_append_recovers_framed_records"
] + [
    (TS.TestTraceParent, name)
    for name in (
        "test_span_from_explicit_parent_across_threads",
        "test_chrome_trace_wall_epoch_anchor",
    )
]


@pytest.mark.parametrize("cls,name", CASES, ids=[f"{c.__name__}.{n}" for c, n in CASES])
def test_telespill_case(monkeypatch, tmp_path, cls, name):
    want = run_case(monkeypatch, tmp_path / "jax", cls, name, port=False)
    got = run_case(monkeypatch, tmp_path / "port", cls, name, port=True)
    assert got == want


def test_sigkill_mid_append_recovers_framed_records(tmp_path):
    """A port child writes 10 records, starts an 11th frame and SIGKILLs
    itself mid-payload: the parent recovers exactly the 10."""
    child = (
        "import os, signal, struct, sys\n"
        "from kubeadmiral_tpu_torch.runtime.telespill import SpillWriter\n"
        "w = SpillWriter(sys.argv[1], instance='victim')\n"
        "for i in range(10):\n"
        "    w.append('spans', {'i': i})\n"
        "w._fh.write(struct.pack('<II', 999, 12345))\n"
        "w._fh.write(b'{\"half\": ')\n"
        "w._fh.flush()\n"
        "os.kill(os.getpid(), signal.SIGKILL)\n"
    )
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run(
        [sys.executable, "-c", child, str(tmp_path)],
        cwd=root, timeout=120, capture_output=True, text=True,
    )
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert [r["i"] for r in load_dir(str(tmp_path))] == list(range(10))
    assert any(n.endswith(".quarantined") for n in os.listdir(tmp_path))


def test_spiller_constants_are_the_jax_defaults(tmp_path):
    assert telespill.ENABLED is True and telespill.TELEMETRY_DIR is None
    assert telespill.SPILL_BYTES == 8 << 20 and telespill.SPILL_INTERVAL_S == 1.0
    assert telespill.TelemetrySpiller().enabled is False  # no directory: no spill
    spiller = telespill.TelemetrySpiller(directory=str(tmp_path))
    assert spiller.enabled and spiller.interval_s == 1.0
    assert spiller._writer.max_bytes == 8 << 20
