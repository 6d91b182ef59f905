"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program either. Top-level module names
are compared whole: the port's name, bng_tpu_torch, begins with the JAX
package's, bng_tpu."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NEVER = {"jax", "jaxlib", "flax", "bng_tpu"}


def imported_tops(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".", 1)[0])
    return tops


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not imported_tops(path) & NEVER


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported_tops(path) & (NEVER | {"bng_tpu_torch"})


def test_top_level_names_are_compared_whole():
    from gpubench import harness

    assert "bng_tpu_torch" not in harness.FORBIDDEN and "bng_tpu" in harness.FORBIDDEN


def test_a_run_loads_no_jax(tmp_path):
    """A whole small run in a fresh interpreter, then its sys.modules."""
    code = (
        "import sys, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import conftest\n"
        "from gpubench import harness\n"
        "bench, ctx = conftest.tiny_context('ipoe_1m.mix_80_20', seconds=0.5)\n"
        "line = harness.execute(ctx, bench)\n"
        "tops = {m.split('.', 1)[0] for m in sys.modules}\n"
        "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'bng_tpu'}), line['correct'])\n"
    ) % (str(ROOT), str(BENCH))
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "TMPDIR": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_refuses_without_the_package(tmp_path):
    """A directory holding only BENCHMARK.json and gpubench/ gives no result."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "gpubench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "TMPDIR": str(tmp_path)}
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "ipoe_1m.mix_80_20",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, env=env, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, "gpubench/run.py", "--workload", "ipoe_1m.mix_80_20",
                          "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr
