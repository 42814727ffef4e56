"""What the benchmark may import: no module under ``benchmark/`` names
JAX or the JAX package (compared by whole top-level name: the port's
name begins with the JAX package's), and the reference names nothing of
the program."""

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "music2midi_tpu"}
PROGRAM = "music2midi_tpu_torch"


def _top_level_imports(path: Path):
    """Every imported module's top-level name in ``path`` (absolute
    imports; a relative import stays inside the benchmark)."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


SOURCES = sorted(PKG.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(PKG)) for p in SOURCES])
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = _top_level_imports(path)
    assert PROGRAM not in names
    assert names <= {"__future__", "collections", "json", "math", "typing",
                     "numpy", "torch"}


def test_the_scan_sees_the_port_and_the_jax_package_apart(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import music2midi_tpu_torch.infer\n"
                 "from music2midi_tpu_torch import train\n")
    assert _top_level_imports(f) == {PROGRAM}
    f.write_text("from music2midi_tpu.infer import Music2MIDI\n")
    assert _top_level_imports(f) & FORBIDDEN == {"music2midi_tpu"}
