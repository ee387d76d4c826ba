"""No module of the harness imports JAX or the JAX package; the reference
imports nothing of the port either. Top-level module names are compared
whole: ``beach_seg_tpu_torch`` (the port) begins with ``beach_seg_tpu``."""

from __future__ import annotations

import ast

import pytest

from portbench.tests.conftest import ROOT

BENCH = ROOT / "portbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "beach_seg_tpu"}


def imported_tops(path) -> set[str]:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_or_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_owes_the_port_nothing(path):
    assert not imported_tops(path) & (FORBIDDEN | {"beach_seg_tpu_torch"})
    assert "portbench.traffic" not in path.read_text() and "portbench.drivers" not in path.read_text()


def test_names_compare_whole(monkeypatch):
    from types import SimpleNamespace

    from portbench import run

    mods = {"beach_seg_tpu_torch": None, "beach_seg_tpu_torch.ops.build": None, "numpy": None}
    monkeypatch.setattr(run, "sys", SimpleNamespace(modules=mods))
    assert run.forbidden_modules() == []
    mods.update({"beach_seg_tpu.config": None, "jaxlib.xla_client": None})
    assert run.forbidden_modules() == ["beach_seg_tpu", "jaxlib"]
