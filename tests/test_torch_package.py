"""The port's top level against the JAX package's: the same attribute
names (the reference's eagerly imported modules and its lazy ``_LAZY``
set), each resolving to the port's module of that name, the exports of
``backends`` and ``utils`` at least the reference's, and all of it without
jax, without the JAX package and without building or loading a kernel."""
import os
import subprocess
import sys
import types

import pytest

from test_torch_host import PORT, REF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def top_level_names():
    """The reference's ``from . import name`` modules (from its source, so
    that what other tests imported does not count) and its ``_LAZY`` set."""
    import ast
    import feynmandiagram_tpu as ref
    with open(ref.__file__) as f:
        tree = ast.parse(f.read())
    eager = sorted(a.name for node in tree.body if isinstance(node, ast.ImportFrom)
                   and node.level == 1 and node.module is None for a in node.names)
    return eager, sorted(ref._LAZY)


def test_reference_names_are_what_the_port_mirrors():
    eager, lazy = top_level_names()
    assert eager == ["computational_graph", "frontends", "models", "quantum_operators",
                     "taylor", "utility"]
    assert lazy == ["backends", "ops", "parallel"]


@pytest.mark.parametrize("name", ["computational_graph", "quantum_operators", "taylor",
                                  "utility", "frontends", "models", "ops", "backends",
                                  "parallel"])
def test_attribute_resolves_in_both(name):
    import feynmandiagram_tpu as ref
    import feynmandiagram_tpu_torch as port
    assert getattr(ref, name).__name__ == f"{REF}.{name}"
    assert getattr(port, name).__name__ == f"{PORT}.{name}"


def test_same_attribute_names():
    import feynmandiagram_tpu_torch as port
    eager, lazy = top_level_names()
    assert sorted(port._LAZY) == lazy
    for name in eager + lazy:
        assert isinstance(getattr(port, name), types.ModuleType), name
    with pytest.raises(AttributeError):
        port.no_such_layer  # noqa: B018


@pytest.mark.parametrize("sub", ["backends", "utils", "frontends.gv", "frontends.gv.generator"])
def test_subpackage_exports_cover_the_reference(sub):
    import importlib
    ref = importlib.import_module(f"{REF}.{sub}")
    port = importlib.import_module(f"{PORT}.{sub}")
    names = {n for n in vars(ref) if not n.startswith("_")
             and not isinstance(getattr(ref, n), types.ModuleType)
             and getattr(getattr(ref, n), "__module__", "").startswith(REF)}
    assert names and names <= set(vars(port)), sorted(names - set(vars(port)))


def test_top_level_without_jax_and_without_a_kernel():
    """A fresh interpreter with jax and the JAX package blocked imports the
    port and resolves every top-level name; no module of either blocked
    package loads, no CUDA context starts and no library of the port's
    build directory is mapped."""
    eager, lazy = top_level_names()
    script = f"""
import sys
sys.modules["jax"] = None
sys.modules["feynmandiagram_tpu"] = None
import feynmandiagram_tpu_torch as fd
for name in {eager + lazy!r}:
    assert getattr(fd, name).__name__ == "feynmandiagram_tpu_torch." + name, name
import torch
assert not torch.cuda.is_initialized()
from feynmandiagram_tpu_torch.ops import build
with open("/proc/self/maps") as f:
    mapped = f.read()
assert build.BUILD_DIR not in mapped
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "feynmandiagram_tpu") and sys.modules[m])
assert not loaded, loaded
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", script], env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr
