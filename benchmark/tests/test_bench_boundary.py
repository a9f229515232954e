"""What the benchmark imports: nothing of JAX or the JAX package anywhere
it runs, and nothing of the program in its yardstick."""

import ast
import subprocess
import sys
from pathlib import Path

from benchmark import harness

BENCH = harness.ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "kubeadmiral_tpu"}
PROGRAM = "kubeadmiral_tpu_torch"
# The only files that reach the program: the harness drives it, the
# adapter builds its objects.
PROGRAM_USERS = {"harness.py", "adapter.py"}


def imported(path: Path) -> set[str]:
    """Top-level names of every module a file imports (relative imports
    stay inside the benchmark)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".", 1)[0])
    return names


def run_files():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts]


def test_no_run_file_imports_jax_or_the_jax_package():
    assert run_files()
    for path in run_files():
        assert not imported(path) & FORBIDDEN, path


def test_only_harness_and_adapter_import_the_program():
    for path in run_files():
        rel = path.relative_to(BENCH)
        if str(rel) not in PROGRAM_USERS:
            assert PROGRAM not in imported(path), rel
    for path in (BENCH / "reference").rglob("*.py"):
        assert PROGRAM not in imported(path), path


def test_harness_process_loads_no_jax():
    """Importing the harness and the engine loads nothing of JAX (the
    result's process checks sys.modules again after its window)."""
    code = (
        "import sys\n"
        "from benchmark import harness, run\n"
        "from kubeadmiral_tpu_torch.scheduler.engine import SchedulerEngine\n"
        "print(run.forbidden_loaded())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_forbidden_names_compare_whole():
    from benchmark import run

    assert run.forbidden_loaded(["kubeadmiral_tpu_torch.ops.phase1", "numpy", "jaxtyping"]) == []
    assert run.forbidden_loaded(["kubeadmiral_tpu.ops", "jaxlib.xla_client", "torch"]) == [
        "jaxlib", "kubeadmiral_tpu"
    ]
