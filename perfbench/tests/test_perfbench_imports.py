"""No module of the benchmark imports JAX, Flax or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the program."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "whisper_flamingo_tpu"}


def _modules(root):
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported_top_levels(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.level > 0:
            names.add("." * node.level + (node.module or ""))
    return names


@pytest.mark.parametrize("path", sorted(_modules(HERE)), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not imported_top_levels(path) & FORBIDDEN


def test_whole_word_match():
    assert "whisper_flamingo_tpu_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", sorted(_modules(os.path.join(HERE, "reference"))),
                         ids=os.path.basename)
def test_reference_is_plain(path):
    names = imported_top_levels(path)
    assert not any(n.startswith("whisper_flamingo_tpu") for n in names)
    assert not any(n.startswith("perfbench") for n in names)
    # relative imports stay inside the reference package
    assert all(n in (".", ".whisper_ref", ".mel_ref", ".bert_ref", ".train_ref")
               for n in names if n.startswith("."))


def test_forbidden_modules_whole_names(monkeypatch):
    import sys
    import types

    from perfbench.run import forbidden_modules

    monkeypatch.setitem(sys.modules, "whisper_flamingo_tpu_torch_x", types.ModuleType("x"))
    assert "whisper_flamingo_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("x"))
    assert forbidden_modules() == ["jaxlib"]
