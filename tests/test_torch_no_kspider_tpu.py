"""kspider_tpu_torch and chip_smoke.py stand alone: no import of kspider_tpu.

Every ``.py`` file under ``kspider_tpu_torch/`` and ``chip_smoke.py`` is
parsed with ``ast``; any ``import kspider_tpu...`` or ``from kspider_tpu...
import`` that is not of ``kspider_tpu_torch`` fails, wherever it sits (top
level, inside a function, inside a string is not code and is not looked at).
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


def jax_package_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names
                      if is_jax_package(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and is_jax_package(node.module):
            found.append((node.lineno, node.module))
    return found


def test_port_sources_found():
    names = {os.path.relpath(p, ROOT) for p in port_sources()}
    for must in ("chip_smoke.py", "kspider_tpu_torch/io/native.py",
                 "kspider_tpu_torch/core/index.py", "kspider_tpu_torch/cli/main.py"):
        assert must in names


@pytest.mark.parametrize("path", port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_of_the_jax_package(path):
    assert jax_package_imports(path) == []


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
