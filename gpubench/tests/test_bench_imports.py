"""What the benchmark imports: never JAX or the JAX package (top-level
names compared whole, since the port's name begins with the JAX
package's), and a reference that imports nothing of the program."""

import ast
import os
import subprocess
import sys

from gpubench import run

BENCH = os.path.join(run.ROOT, "gpubench")


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources():
    for base, _, files in os.walk(BENCH):
        for name in files:
            if name.endswith(".py"):
                yield os.path.join(base, name)


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        found = top_level_imports(path) & set(run.FORBIDDEN)
        assert not found, (path, found)


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "datagen.py", "check.py", "roofline.py"):
        names = top_level_imports(os.path.join(BENCH, name))
        assert names <= {"numpy", "json", "os", "dataclasses", "typing", "gpubench"}, names
    for name in ("check.py",):
        with open(os.path.join(BENCH, name)) as f:
            assert "kspider" not in f.read()


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "kspider_tpu_torch_like", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "kspider_tpu.sub", sys)
    assert run.forbidden_modules() == ["kspider_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package_nor_the_reference_the_program(tmp_path):
    """A whole tiny run on the CPU in a fresh process: afterwards no
    forbidden module is loaded, and the reference's check loaded no part
    of the program's native library."""
    from conftest import make_root

    root = str(tmp_path)
    make_root(root)
    script = (
        "import sys, json\n"
        f"sys.path.insert(0, {run.ROOT!r})\n"
        "from gpubench import run\n"
        f"r = run.run_cell(run.load_benchmark({root!r}), 'tiny.pipeline', 5, 0.2, False,"
        f" device='cpu', root={root!r})\n"
        "print(json.dumps([r['correct'], run.forbidden_modules()]))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[true, []]"


def test_reference_alone_loads_nothing_of_the_program():
    script = ("import sys\n"
              f"sys.path.insert(0, {run.ROOT!r})\n"
              "from gpubench import check, control, datagen, reference, roofline\n"
              "col = datagen.generate({'genomes': 64, 'group_size': 8, 'core_hashes': [45, 65],"
              " 'retention': [0.6, 0.95], 'own_hashes': [8, 18], 'cross_hashes_per_8192': 2000,"
              " 'cross_degree': [16, 64], 'ksize': 21}, 1)\n"
              "check.Expected(col)\n"
              "print(sorted(m for m in sys.modules if m.split('.')[0].startswith('kspider')"
              " or m.split('.')[0] in ('torch', 'jax')))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "[]"
