"""The benchmark loads neither JAX nor the JAX package: the run's check of
``sys.modules`` by whole top-level names, and a scan of its sources."""

import ast
import glob
import os
import sys
import types

import pytest

from portbench import harness


@pytest.mark.parametrize("name,bad", [
    ("diffbinaural_tpu", True), ("diffbinaural_tpu.models", True),
    ("jax", True), ("jaxlib.xla_client", True), ("flax", True),
    ("optax", True), ("diffbinaural_tpu_torch", False),
    ("diffbinaural_tpu_torch.models", False), ("jaxtyping", False)])
def test_forbidden_by_whole_top_level_name(monkeypatch, name, bad):
    for mod in harness.FORBIDDEN:
        monkeypatch.delitem(sys.modules, mod, raising=False)
    for mod in list(sys.modules):
        if mod.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, mod)
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert bool(harness.forbidden_modules()) is bad
    if bad:
        with pytest.raises(harness.BenchError):
            harness.assert_no_forbidden("now")


def test_sources_import_nothing_forbidden():
    banned = set(harness.FORBIDDEN) | {"bench", "benchmarks", "chip_smoke"}
    for path in glob.glob(os.path.join(harness.HERE, "**", "*.py"),
                          recursive=True):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            assert not {n.split(".")[0] for n in names} & banned, path


def test_reference_imports_nothing_of_the_port():
    for path in glob.glob(os.path.join(harness.HERE, "reference", "*.py")):
        assert "diffbinaural_tpu" not in open(path).read(), path
