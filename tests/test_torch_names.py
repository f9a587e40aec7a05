"""The port's public names: every name a JAX package ``__init__`` imports
is found at the port's mirrored path.

Each JAX ``__init__`` is read with ``ast`` (nothing of it is imported, so
no ``jax``), for each package the port mirrors: the root, ``core``,
``ops``, ``solvers``, ``precond``, ``models``, ``utils`` and ``parallel``.
EXEMPT lists the only names allowed to be missing, each with its reason.
Two JAX modules that no ``__init__`` re-exports, ``parallel/rung5.py`` and
``precond/distributed.py``, are held whole (MODULES): the port's modules
have every top-level function and class of theirs.
"""

import ast
import importlib
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "conjugategradient_tpu"
PACKAGES = ["", "core", "ops", "solvers", "precond", "models", "utils", "parallel"]

#: (package, name) -> why the port does not have it
EXEMPT = {
    ("ops", "dd"): "ROADMAP: not to port (TPU double-float arithmetic)",
    ("ops", "pallas_spmv"): "ROADMAP: not to port (the Pallas kernels' module)",
}


def _imported_names(package: str):
    """The names the JAX ``__init__`` of ``package`` binds by its imports,
    in order (``import a.b as c`` binds c, ``from m import x as y`` binds
    y)."""
    path = JAX_PKG / package / "__init__.py"
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
        elif isinstance(node, ast.Import):
            names += [a.asname or a.name.split(".")[0] for a in node.names]
    return [n for n in names if n != "annotations"]


@pytest.mark.parametrize("package", PACKAGES, ids=lambda p: p or "root")
def test_port_has_every_public_name(package):
    port = importlib.import_module(
        "conjugategradient_tpu_torch" + (f".{package}" if package else ""))
    names = _imported_names(package)
    assert names, f"no names read from the JAX {package or 'root'} __init__"
    missing = [n for n in names if not hasattr(port, n) and (package, n) not in EXEMPT]
    assert not missing, f"{package or 'root'}: the port lacks {missing}"


#: JAX modules no ``__init__`` re-exports, held whole: every top-level
#: function and class of the JAX module, private ones too, is in the port's
MODULES = ["parallel/rung5.py", "precond/distributed.py"]


@pytest.mark.parametrize("path", MODULES)
def test_port_module_has_every_top_level_function(path):
    tree = ast.parse((JAX_PKG / path).read_text())
    names = [n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    assert names, f"no functions read from the JAX {path}"
    port = importlib.import_module("conjugategradient_tpu_torch." + path[:-3].replace("/", "."))
    missing = [n for n in names if not callable(getattr(port, n, None))]
    assert not missing, f"{path}: the port lacks {missing}"


def test_exemptions_are_exactly_the_missing_names():
    """Each exemption is still a JAX name and still missing from the port:
    an exemption that a later port fills must be taken off the list."""
    for (package, name), why in EXEMPT.items():
        assert name in _imported_names(package), (package, name)
        port = importlib.import_module(
            "conjugategradient_tpu_torch" + (f".{package}" if package else ""))
        assert not hasattr(port, name), f"{package}.{name} is ported now: drop its exemption ({why})"


def test_ops_spmm_is_the_function_and_the_facade_names_import():
    """As in the JAX package ``ops.spmm`` ends as the function; the root
    takes the solve and eigensolve facades, the containers and the DOK
    builder."""
    from conjugategradient_tpu_torch import (  # noqa: F401
        BsrMatrix,
        CooMatrix,
        CsrMatrix,
        DenseMatrix,
        DiaMatrix,
        DokBuilder,
        EllMatrix,
        eigs,
        solve,
    )
    from conjugategradient_tpu_torch import api, ops
    from conjugategradient_tpu_torch.ops.spmm import spmm

    assert ops.spmm is spmm and callable(ops.spmm)
    assert eigs is api.eigs and solve is api.solve
