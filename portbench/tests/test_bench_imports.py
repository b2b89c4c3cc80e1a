"""No module under portbench/ imports jax, jaxlib, flax or the JAX package
(geosongpu_tpu), compared by the whole top-level name, and the reference
imports nothing of the program (geosongpu_tpu_torch) or of the rest of the
harness."""
import ast
import pathlib
import sys

import pytest

from pbhelpers import ROOT, load_run

BENCH = pathlib.Path(ROOT) / "portbench"
JAX = {"jax", "jaxlib", "flax", "geosongpu_tpu"}
SOURCES = sorted(BENCH.rglob("*.py"))


def imported(path: pathlib.Path) -> set:
    """The top-level names of the modules `path` imports; a relative import
    as the absolute name it resolves to."""
    package = path.relative_to(ROOT).parent.parts
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[:len(package) - node.level + 1]
                names.add(".".join(base + ((node.module,) if node.module
                                           else ())))
            else:
                names.add(node.module)
    return names


def test_the_scan_reads_every_source():
    assert len(SOURCES) > 30
    assert "geosongpu_tpu_torch.models.held_suarez" in imported(
        BENCH / "drive.py")
    assert "portbench.reference.core.grid" in imported(
        BENCH / "reference" / "models" / "held_suarez.py")


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax(path):
    assert not {n for n in imported(path) if n.split(".")[0] in JAX}


@pytest.mark.parametrize(
    "path", [p for p in SOURCES if "reference" in p.parts],
    ids=[str(p.relative_to(BENCH)) for p in SOURCES
         if "reference" in p.parts])
def test_reference_stands_alone(path):
    for n in imported(path):
        top = n.split(".")
        assert top[0] != "geosongpu_tpu_torch", n
        assert top[0] != "portbench" or top[1] == "reference", n


def test_whole_names_are_compared():
    run = load_run()
    sys.modules["geosongpu_tpu_torch_probe"] = sys
    sys.modules["geosongpu_tpu.probe"] = sys
    try:
        found = run.forbidden_modules()
    finally:
        del sys.modules["geosongpu_tpu_torch_probe"]
        del sys.modules["geosongpu_tpu.probe"]
    assert "geosongpu_tpu.probe" in found
    assert not [m for m in found if m.startswith("geosongpu_tpu_torch")]
