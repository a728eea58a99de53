"""Nothing under benchmark/ imports JAX, its libraries or the JAX package,
compared by whole top-level names (the port's name begins with the JAX
package's), and the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "pace_tpu"}


def imported_top_levels(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".", 1)[0]


SOURCES = sorted(ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not set(imported_top_levels(path)) & BANNED


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_reference_imports_nothing_of_the_program(path):
    assert "pace_tpu_torch" not in set(imported_top_levels(path))
    assert "benchmark" not in set(imported_top_levels(path))


def test_whole_name_comparison():
    """The check compares whole top-level names: the port passes, the JAX
    package does not."""
    from benchmark import harness

    import sys
    import types

    sys.modules["pace_tpu_torch_probe_only"] = types.ModuleType("pace_tpu_torch_probe_only")
    try:
        assert harness.jax_modules() == []
        sys.modules["pace_tpu.fake"] = types.ModuleType("pace_tpu.fake")
        assert harness.jax_modules() == ["pace_tpu"]
    finally:
        sys.modules.pop("pace_tpu_torch_probe_only", None)
        sys.modules.pop("pace_tpu.fake", None)
