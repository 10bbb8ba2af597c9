"""No module under benchmark/ imports JAX, flax or the JAX package, and
the harness and the reference import nothing of the repository's older
scripts; top-level names are compared whole (meshclust2_tpu_torch begins
with meshclust2_tpu)."""
import ast
import os

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "meshclust2_tpu", "bench", "chip_smoke",
             "ab_paths", "kernel_ab"}


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def sources():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_forbidden_imports():
    found = {(os.path.relpath(p, BENCH), m) for p in sources()
             for m in top_level_imports(p) if m in FORBIDDEN}
    assert not found


def test_the_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    found = {(f, m) for f in os.listdir(ref) if f.endswith(".py")
             for m in top_level_imports(os.path.join(ref, f))
             if m.startswith("meshclust2") or m in ("harness", "metrics")}
    assert not found


def test_whole_name_comparison():
    from harness.main import FORBIDDEN as RUNTIME

    assert "meshclust2_tpu_torch".split(".")[0] not in RUNTIME
    assert {"jax", "jaxlib", "flax", "meshclust2_tpu"} <= RUNTIME
