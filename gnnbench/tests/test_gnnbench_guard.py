"""The import guard, and the reference's independence of the program."""

import ast
from pathlib import Path

from gnnbench import guard

BENCH = Path(__file__).resolve().parents[1]


def test_guard_compares_whole_top_level_names():
    found = guard.forbidden_loaded(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                                    "tpugraph", "tpugraph.nn.layers", "tpugraph_torch",
                                    "tpugraph_torch.nn", "jaxtyping", "numpy"])
    assert found == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "tpugraph",
                     "tpugraph.nn.layers"]


def test_the_port_loads_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.path.insert(0, %r); import tpugraph_torch.train.loop, "
            "tpugraph_torch.explain.explainer; from gnnbench import guard; "
            "print(guard.forbidden_loaded())" % str(BENCH.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_and_data_import_nothing_of_the_program():
    for sub in ("reference", "data"):
        for path in (BENCH / sub).glob("*.py"):
            for name in _imports(path):
                assert name.split(".")[0] not in ("tpugraph_torch", "tpugraph", "jax"), (
                    path, name)


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in guard.FORBIDDEN, (path, name)
