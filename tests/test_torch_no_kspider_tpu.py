"""kspider_tpu_torch and chip_smoke.py stand alone: no import of kspider_tpu.

Every ``.py`` file under ``kspider_tpu_torch/`` and ``chip_smoke.py`` is
parsed with ``ast``; any ``import kspider_tpu...`` or ``from kspider_tpu...
import`` that is not of ``kspider_tpu_torch`` fails, wherever it sits (top
level, inside a function, inside a string is not code and is not looked at).
The same walk holds the port's layers apart: no module under
``kspider_tpu_torch/ops/`` imports ``kspider_tpu_torch.core``.
"""

import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "kspider_tpu_torch")):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def is_jax_package(module: str) -> bool:
    return module == "kspider_tpu" or module.startswith("kspider_tpu.")


def is_core(module: str) -> bool:
    return module == "kspider_tpu_torch.core" or \
        module.startswith("kspider_tpu_torch.core.")


def imports_matching(path, matches, package=None):
    """``(line, module)`` of every import in ``path`` of a module that
    ``matches``: ``import m``, ``from m import x``, and ``from p import m``
    of a submodule; a relative import is resolved against ``package`` (a
    list of names; by default the file's own package under the repo)."""
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    if package is None:
        package = os.path.relpath(os.path.dirname(path), ROOT).split(os.sep)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names
                      if matches(a.name)]
        elif isinstance(node, ast.ImportFrom):
            base = package[:len(package) - node.level + 1] if node.level else []
            module = ".".join(base + ([node.module] if node.module else []))
            names = [module] + [f"{module}.{a.name}" for a in node.names]
            found += [(node.lineno, m) for m in names if matches(m)][:1]
    return found


def jax_package_imports(path):
    return imports_matching(path, is_jax_package)


def test_port_sources_found():
    names = {os.path.relpath(p, ROOT) for p in port_sources()}
    for must in ("chip_smoke.py", "kspider_tpu_torch/io/native.py",
                 "kspider_tpu_torch/core/index.py", "kspider_tpu_torch/cli/main.py"):
        assert must in names


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_of_the_jax_package(path):
    assert jax_package_imports(path) == []


def ops_sources():
    return [p for p in port_sources()
            if os.path.relpath(p, ROOT).startswith("kspider_tpu_torch/ops/")]


@pytest.mark.parametrize("path", ops_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_ops_import_nothing_of_core(path):
    assert imports_matching(path, is_core) == []


@pytest.mark.parametrize("source,bad", [
    ("import kspider_tpu\n", True),
    ("import kspider_tpu.io.native as n\n", True),
    ("from kspider_tpu.core import index\n", True),
    ("def f():\n    from kspider_tpu.io import phmap\n", True),
    ("import kspider_tpu_torch\nfrom kspider_tpu_torch.io import native\n", False),
    ("from . import native\ns = 'from kspider_tpu import x'\n", False),
])
def test_the_check_finds_what_it_must(tmp_path, source, bad):
    path = tmp_path / "m.py"
    path.write_text(source)
    assert bool(jax_package_imports(str(path))) == bad


@pytest.mark.parametrize("source,bad", [
    ("from kspider_tpu_torch.core import index\n", True),
    ("import kspider_tpu_torch.core.pairwise as p\n", True),
    ("def f():\n    from kspider_tpu_torch import core\n", True),
    ("from ..core.index import ColorIndex\n", True),
    ("from kspider_tpu_torch.io import pairwise_tsv\nfrom . import bitmask\n",
     False),
    ("from kspider_tpu_torch.ops import core_helpers\n", False),
])
def test_the_layer_check_finds_what_it_must(tmp_path, source, bad):
    path = tmp_path / "m.py"
    path.write_text(source)
    found = imports_matching(str(path), is_core, ["kspider_tpu_torch", "ops"])
    assert bool(found) == bad
