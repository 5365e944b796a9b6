"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module name (the port's name begins with the JAX
package's), and nothing reads the JAX bench or its results."""

import ast
from pathlib import Path

import pytest

import perfbench
from perfbench import cells

RUN = cells._module(cells.HERE / "run.py", "perfbench.run_main")
SOURCES = sorted(p for p in Path(perfbench.__file__).parent.rglob("*.py")
                 if "__pycache__" not in p.parts)


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(cells.HERE))
                              for p in SOURCES])
def test_no_jax_import(path):
    assert not imported_tops(path) & set(RUN.FORBIDDEN)


def test_whole_name_comparison(monkeypatch):
    import sys
    import types
    monkeypatch.setitem(sys.modules, "sddmm_tpu_torch_shadow",
                        types.ModuleType("sddmm_tpu_torch_shadow"))
    assert RUN.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sddmm_tpu.ops",
                        types.ModuleType("sddmm_tpu.ops"))
    assert RUN.forbidden_modules() == ["sddmm_tpu.ops"]


def test_the_port_is_imported_and_jax_is_not():
    tops = set().union(*map(imported_tops, SOURCES))
    assert "sddmm_tpu_torch" in tops
    assert "sddmm_tpu" not in tops and "jax" not in tops


def test_no_jax_bench_or_results_read():
    for path in SOURCES:
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert "results/" not in text and "BENCH_r" not in text, path
        assert "TUNED_CONFIGS" not in text, path
