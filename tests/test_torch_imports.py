"""The port never imports jax, and builds nothing at import.

Checked in a fresh interpreter, because tests/conftest.py imports jax into
the test process itself."""
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
assert len(names) >= 13, names
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "triton")))
assert not bad, bad
from meshclust2_tpu_torch.ops._build import load
assert load.cache_info().currsize == 0   # nothing built at import
print("imported", len(names))
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "imported" in res.stdout


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
