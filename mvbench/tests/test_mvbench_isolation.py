"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference imports nothing of the program. Names are compared whole: the
port's ``videomv_tpu_torch`` begins with the JAX package's name."""

import ast
import os
import sys

from mvbench import run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "videomv_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        if os.sep + "tests" in dirpath[len(BENCH):]:
            continue
        yield from (os.path.join(dirpath, f) for f in files if f.endswith(".py"))


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    bad = {p: sorted(set(_imports(p)) & FORBIDDEN) for p in _sources()}
    assert not {p: b for p, b in bad.items() if b}


def test_the_reference_imports_nothing_of_the_program():
    bad = {p: sorted(set(_imports(p)) & (FORBIDDEN | {"videomv_tpu_torch"}))
           for p in _sources("reference")}
    assert not {p: b for p, b in bad.items() if b}


def test_the_run_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "videomv_tpu_torchlike", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", sys)
    before = run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "videomv_tpu.models", sys)
    assert set(run.forbidden_modules()) - set(before) >= {"jax", "videomv_tpu"}
    assert "videomv_tpu_torchlike" not in run.forbidden_modules()
    assert "jaxfoo" not in run.forbidden_modules()
