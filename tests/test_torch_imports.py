"""The port stands alone: it never imports jax or the JAX package, and
builds nothing at import.

Checked by an AST scan of every import statement of the port and of
chip_smoke.py, and in a fresh interpreter (tests/conftest.py imports jax
into the test process itself) that imports every module of the port, then
trains and clusters small.fasta through the port's CLI."""
import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

from meshclust2_tpu_torch.runtime import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import meshclust2_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
assert len(names) >= 40, names


def foreign():
    return sorted(m for m in sys.modules if m == "jax" or m == "meshclust2_tpu"
                  or m.startswith(("jax.", "triton", "meshclust2_tpu.")))


assert not foreign(), foreign()
from meshclust2_tpu_torch.ops._build import load
assert load.cache_info().currsize == 0   # nothing built at import
print("imported", len(names))
"""

# then a whole run: training, then clustering, on the CPU
RUN = PROBE + """
from meshclust2_tpu_torch import cli
res = cli.run(["--device", "cpu", "--id", "0.9", "--kmer", "5",
               "--mut-type", "single", "--output", "out.clstr",
               sys.argv[1]])
assert res.rc == 0 and res.trained is not None and res.engine is not None
assert not foreign(), foreign()
print("ran")
"""


def probe(script, cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, "-c", script, *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    res = probe(PROBE, ROOT)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


def test_port_run_leaves_no_jax_in_sys_modules(tmp_path):
    res = probe(RUN, tmp_path, os.path.join(ROOT, "tests", "fixtures",
                                            "small.fasta"))
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ran" in res.stdout
    assert (tmp_path / "out.clstr").stat().st_size > 0


def imported_modules(path):
    """Every module named by an import statement of the file, module-level
    or inside a function, relative imports resolved against the file's
    package."""
    rel = os.path.relpath(path, ROOT)
    package = os.path.dirname(rel).replace(os.sep, ".").split(".")
    if os.path.basename(path) == "__init__.py":
        package.append("")
    names = []
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = package[:len(package) - node.level + 1] if \
                    os.path.basename(path) != "__init__.py" else \
                    package[:len(package) - node.level]
                mod = ".".join(p for p in base if p)
                mod = f"{mod}.{node.module}" if node.module else mod
            else:
                mod = node.module
            names.append(mod)
            names += [f"{mod}.{a.name}" for a in node.names]
    return names


PORT_FILES = sorted(glob.glob(os.path.join(ROOT, "meshclust2_tpu_torch", "**",
                                           "*.py"), recursive=True))


@pytest.mark.parametrize("path", PORT_FILES + [os.path.join(ROOT, "chip_smoke.py")],
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_names_the_jax_package(path):
    mods = imported_modules(path)
    bad = [m for m in mods if m == "meshclust2_tpu"
           or m.startswith("meshclust2_tpu.") or m == "jax"
           or m.startswith("jax.")]
    assert not bad, bad


def test_import_scan_resolves_relative_imports():
    mods = imported_modules(os.path.join(ROOT, "meshclust2_tpu_torch",
                                         "train", "predictor.py"))
    assert "meshclust2_tpu_torch.features.host" in mods
    assert "meshclust2_tpu_torch.train.selectors" in mods
    assert "meshclust2_tpu_torch.kmer.counting.concat_point_sets" in mods


@pytest.mark.parametrize("name,ok", [("cpu", True), ("tpu", False)])
def test_resolve_device(name, ok):
    if ok:
        assert resolve_device(name) == torch.device(name)
    else:
        with pytest.raises(ValueError):
            resolve_device(name)


def test_resolve_cuda_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
