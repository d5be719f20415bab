"""The port stands alone: no JAX and nothing of the reference package.

An AST scan (nothing is imported, so it runs without torch) of every
module under ``src/repro_torch``, of ``chip_smoke.py``, of the scripts
under ``tools/`` that measure the port, and of the GPU tests (which run
where there is no JAX): an import of
``jax``, ``jaxlib`` or ``repro`` anywhere — top level, inside a function,
or under a guard — fails.  Relative imports stay inside the port.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}
FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "tests" / "test_torch_kernels_cuda.py",
] + sorted((REPO / "tools").glob("*.py"))


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, (ast.Name, ast.Attribute))
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value).split(".")[0]


def test_the_port_has_modules_to_scan():
    assert len(FILES) > 10
    assert all(path.is_file() for path in FILES)


@pytest.mark.parametrize("path", FILES,
                         ids=[p.relative_to(REPO).as_posix() for p in FILES])
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    bad = [(line, root) for line, root in _imported_roots(tree)
           if root in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_scanner_catches_forbidden_imports():
    src = ("import jax.numpy as jnp\n"
           "def f():\n    from repro.store import Repository\n"
           "try:\n    import jaxlib\nexcept ImportError:\n    pass\n"
           "import importlib\nimportlib.import_module('repro.kernels')\n"
           "from . import repro\nimport repro_torch\n")
    roots = {root for _, root in _imported_roots(ast.parse(src))}
    assert FORBIDDEN <= roots
    assert "repro_torch" in roots


# -- layering: the models and the distributed layer import nothing of launch

LOWER = sorted((REPO / "src" / "repro_torch" / "models").glob("*.py")) \
    + sorted((REPO / "src" / "repro_torch" / "distributed").glob("*.py"))


def _imported_modules(path: Path, tree: ast.AST):
    """Every module an import names, made absolute against ``path``'s
    package (``from .. import launch`` names ``repro_torch.launch``)."""
    package = list(path.relative_to(REPO / "src").with_suffix("").parts[:-1])
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            base = (package[:len(package) - node.level + 1] if node.level
                    else [])
            mod = base + (node.module.split(".") if node.module else [])
            for alias in node.names:
                yield node.lineno, ".".join(mod + [alias.name])


@pytest.mark.parametrize("path", LOWER,
                         ids=[p.relative_to(REPO).as_posix() for p in LOWER])
def test_models_and_distributed_import_nothing_of_launch(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    up = [(line, mod) for line, mod in _imported_modules(path, tree)
          if mod.startswith("repro_torch.launch")]
    assert not up, f"{path.relative_to(REPO)} imports {up}"


def test_layering_scanner_resolves_relative_imports():
    path = REPO / "src" / "repro_torch" / "models" / "layers.py"
    src = ("from ..launch.mesh import set_mesh\n"
           "def f():\n    from .. import launch\n"
           "from .attention import x\nimport repro_torch.launch.train\n")
    mods = {m for _, m in _imported_modules(path, ast.parse(src))}
    assert mods == {"repro_torch.launch.mesh.set_mesh",
                    "repro_torch.launch",
                    "repro_torch.models.attention.x",
                    "repro_torch.launch.train"}
