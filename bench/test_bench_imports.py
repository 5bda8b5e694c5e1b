"""No module under ``bench/`` imports JAX or the JAX package, and the
reference imports nothing of the port: each import's top-level name (the
part before the first dot) is compared whole, since the port's name
``repro_torch`` begins with the JAX package's ``repro``.  The runtime
guard of ``bench/run.py`` compares the same way."""
import ast
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _top_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not set(_top_names(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "repro_torch" not in set(_top_names(path))


def test_runtime_guard_names_what_is_loaded(monkeypatch):
    sys.path.insert(0, str(BENCH))
    try:
        import run
    finally:
        sys.path.remove(str(BENCH))
    before = set(run.forbidden_modules())     # what other tests loaded
    monkeypatch.setitem(sys.modules, "repro_torch_x", object())
    monkeypatch.setitem(sys.modules, "jaxlike", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "repro.core", object())
    found = run.forbidden_modules()
    assert set(found) == before | {"jax", "repro"}
    assert found == sorted(found)


def test_run_refuses_without_a_card(monkeypatch):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal is not reached")
    sys.path.insert(0, str(BENCH))
    try:
        import run
    finally:
        sys.path.remove(str(BENCH))
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.delenv(var, raising=False)     # restored afterwards
    assert run.main(["--workload", "zoo12-steady", "--seed", "1",
                     "--seconds", "1"]) == 2
