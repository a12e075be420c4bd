"""Nothing under pccbench/ imports JAX or the JAX package, and the
yardstick (reference, generators, byte counts) imports nothing of the
port either.  Top-level module names are compared whole: the port,
``mpeg_pcc_tmc13_tpu_torch``, starts with the JAX package's name."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "mpeg_pcc_tmc13_tpu", "bench", "chip_smoke"}
PORT = "mpeg_pcc_tmc13_tpu_torch"
YARDSTICK = ("reference", "gen", "roofline", "checks")


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(PKG)) for p in SOURCES])
def test_no_jax_anywhere(path):
    assert not set(top_level_imports(path)) & NEVER


@pytest.mark.parametrize("part", YARDSTICK)
def test_yardstick_imports_nothing_of_the_port(part):
    for path in (PKG / part).rglob("*.py"):
        names = set(top_level_imports(path))
        assert PORT not in names and not names & NEVER, path


def test_names_compared_whole():
    """A prefix test would wrongly refuse the port, or let the JAX
    package pass where its name is a prefix of another."""
    assert PORT.startswith("mpeg_pcc_tmc13_tpu")
    assert PORT not in NEVER and "mpeg_pcc_tmc13_tpu" in NEVER


def test_only_codec_imports_the_port():
    users = {p.relative_to(PKG).as_posix() for p in SOURCES
             if PORT in set(top_level_imports(p))}
    tests = {"tests/test_reference.py", "tests/test_run_cpu.py",
             "tests/test_codecs.py"}
    assert all(u.startswith("codecs/") for u in users - tests), users
