"""What the benchmark loads: nothing of JAX or of the JAX package (top-level
names compared whole: the port's own name begins with the JAX package's),
and nothing of the program in the reference."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "cellularautomatons3d_tpu"}


def test_harness_with_the_port_loads_no_jax():
    code = (
        "import sys, json, time; sys.path[:0] = [%r, %r]\n"
        "import harness, control\n"
        "from cellularautomatons3d_tpu_torch import Engine\n"
        "harness.load_cell('pbr256.orbit'); harness.counters()\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    ) % (str(BENCH), str(BENCH.parent))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    top = set(json.loads(p.stdout.splitlines()[-1]))
    assert "cellularautomatons3d_tpu_torch" in top
    assert not top & FORBIDDEN


def test_the_check_of_loaded_modules_compares_whole_names(monkeypatch):
    import harness
    monkeypatch.setitem(sys.modules, "cellularautomatons3d_tpu_torch_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def _imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_sources_import_neither_jax_nor_the_old_bench(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, name
        assert top not in ("bench_torch", "bench", "tools"), name
        assert not name.startswith("cellularautomatons3d_tpu_torch.tools"), name
    text = path.read_text()
    assert "BENCH_r0" not in text and "bench_out" not in text


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for name in _imports(path):
        assert name.split(".")[0] in ("numpy", "torch", "contextlib", "functools", "typing",
                                      "__future__"), name
