"""Nothing the benchmark runs imports JAX, the JAX package `repro`, the JAX
package's harness or `chip_smoke.py`; the reference imports nothing of the
program.  Module names are compared whole, by their top-level part:
`repro_torch` begins with `repro` and is not it."""
import ast
import subprocess
import sys

import pytest

from conftest import ROOT
from f2bench import harness

BENCH = ROOT / "f2bench"
BANNED = {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke"}


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def sources():
    return [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_banned_import(path):
    assert not set(imported_tops(path)) & BANNED


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "gen.py"):
        assert "repro_torch" not in set(imported_tops(BENCH / name))


@pytest.mark.parametrize("modules,found", [
    (["repro_torch", "repro_torch.core.api", "torch"], []),
    (["repro", "repro_torch"], ["repro"]),
    (["repro.core.store"], ["repro"]),
    (["jax", "jaxlib.xla_client", "flax.linen"], ["flax", "jax", "jaxlib"]),
    (["reprox", "jax_extra", "jaxx"], []),
])
def test_forbidden_loaded_compares_whole_top_level_names(modules, found):
    assert harness.forbidden_loaded(modules) == found


def test_a_run_process_loads_no_jax():
    # the program and the harness as run.py imports them
    code = ("import sys; sys.path[:0] = [%r, %r]; import repro_torch, "
            "repro_torch.core; from f2bench import harness, manifest, "
            "reference, gen, profiling, roofline; "
            "print(harness.forbidden_loaded())" % (str(ROOT / "src"), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
