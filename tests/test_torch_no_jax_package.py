"""No module of the port, not chip_smoke.py and not the card's design
capture (tools/capture_group_designs.py, which chip_smoke.py imports)
imports jax or the JAX package channel_pruning_tpu: an AST scan of every
import statement, those inside functions included, and of every
`importlib.import_module` / `__import__` call with a literal module
name."""
import ast
from pathlib import Path

import pytest
from torch_cpu import one_thread  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
FILES = sorted((REPO / "channel_pruning_tpu_torch").rglob("*.py")) + \
    [REPO / "chip_smoke.py", REPO / "tools" / "capture_group_designs.py"]
BLOCKED = ("jax", "channel_pruning_tpu")


def imported_modules(source: str) -> set[str]:
    """Every absolute module name the source imports, at any depth."""
    mods = set()
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.add(node.module)
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else \
                getattr(fn, "id", None)
            if name in ("import_module", "__import__"):
                mods.add(node.args[0].value)
    return mods


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_jax_or_the_jax_package(path):
    bad = {m for m in imported_modules(path.read_text())
           if m.split(".")[0] in BLOCKED}
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_scan_sees_lazy_and_dynamic_imports():
    src = ("import os\n"
           "def f():\n"
           "    from channel_pruning_tpu.io import caffe\n"
           "    import jax.numpy as jnp\n"
           "    importlib.import_module('channel_pruning_tpu.models')\n"
           "from . import sibling\n")
    mods = imported_modules(src)
    assert {"channel_pruning_tpu.io", "jax.numpy",
            "channel_pruning_tpu.models"} <= mods
    assert "sibling" not in mods and "os" in mods
