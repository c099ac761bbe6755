"""What the benchmark imports: nothing of JAX, the JAX package, ``bench``
or ``chip_smoke`` anywhere under ``portbench/`` (top-level module names
compared whole: the port's name begins with the JAX package's), and the
reference nothing of the measured program."""

import ast
import subprocess
import sys

import pytest

from portbench.harness.manifest import PORTBENCH, ROOT

BANNED = {"jax", "jaxlib", "flax", "multimodal_plankton_recognition_tpu",
          "bench", "chip_smoke"}
PROGRAM = "multimodal_plankton_recognition_torch"
SOURCES = sorted(p for p in PORTBENCH.rglob("*.py")
                 if "tests" not in p.relative_to(PORTBENCH).parts)


def _imports(path):
    """(top-level names of absolute imports, relative imports' levels)."""
    tops, levels = set(), set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                levels.add(node.level)
            else:
                tops.add(node.module.split(".")[0])
    return tops, levels


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(PORTBENCH)) for p in SOURCES])
def test_no_jax_anywhere(path):
    tops, _ = _imports(path)
    assert not tops & BANNED
    # the port's own name shares the JAX package's prefix: whole names
    assert "multimodal_plankton_recognition_tpu" not in tops


def test_reference_imports_nothing_of_the_program():
    for path in (PORTBENCH / "reference").glob("*.py"):
        tops, levels = _imports(path)
        assert PROGRAM not in tops and "portbench" not in tops, path
        assert levels <= {1}, path  # only its own siblings


def test_whole_names_are_compared():
    """A module whose name only begins with a banned one is not banned,
    and the port's package is not the JAX package."""
    from portbench.harness.runner import BANNED as RUN_BANNED

    assert PROGRAM not in RUN_BANNED
    assert {"jax", "jaxlib", "flax",
            "multimodal_plankton_recognition_tpu"} <= set(RUN_BANNED)


def test_loading_everything_loads_no_jax():
    """Every module of the benchmark and the program's modules the
    drivers call, imported in a fresh process: no JAX among
    ``sys.modules``' top-level names."""
    code = f"""
import sys, importlib, pathlib
sys.path.insert(0, {str(ROOT)!r})
from portbench.harness import manifest, runner
for p in sorted(pathlib.Path({str(PORTBENCH)!r}).rglob('*.py')):
    rel = p.relative_to({str(PORTBENCH)!r})
    if 'tests' in rel.parts or p.name in ('run.py', 'control.py'):
        continue
    if rel.parts[0] == 'metrics':
        manifest.metric_module(p.name[:-3])
    elif p.name != '__init__.py':
        name = '.'.join(rel.with_suffix('').parts)
        importlib.import_module('portbench.' + name)
import {PROGRAM}.train.loop, {PROGRAM}.retrieval.export
import {PROGRAM}.retrieval.encode, {PROGRAM}.models.build
tops = {{m.split('.')[0] for m in sys.modules}}
print(sorted(tops & set({sorted(BANNED)!r})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    assert out.stdout.strip().splitlines()[-1] == "[]"
