"""The port's copies of the JAX package's remaining host modules against the
JAX functions on the same seeded inputs (exact): utils/lcs.py, utils/align.py
(also against the reference binary's align_golden.tsv), kmer/histogram.py and
red/random_chrom.py; the CLI's --profile (a torch.profiler trace, the run
itself unchanged); the console scripts and package data that name the port;
and the two packages' file lists."""
import glob
import importlib
import json
import os
import tomllib

import numpy as np
import pytest

from meshclust2_tpu_torch import cli as torch_cli
from meshclust2_tpu_torch.kmer.histogram import RawHistogram
from meshclust2_tpu_torch.red.random_chrom import markov_random_chromosome
from meshclust2_tpu_torch.utils.align import global_align_identity
from meshclust2_tpu_torch.utils.lcs import lcs_length

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def random_dna(rng, n, alphabet="ACGT"):
    return "".join(rng.choice(list(alphabet), n))


def mutated(rng, s, rate):
    out = []
    for ch in s:
        r = rng.random()
        if r < rate / 3:
            continue                                   # deletion
        out.append(rng.choice(list("ACGT")) if r < 2 * rate / 3 else ch)
        if rng.random() < rate / 3:
            out.append(rng.choice(list("ACGT")))       # insertion
    return "".join(out)


@pytest.mark.parametrize("seed", range(4))
def test_lcs_length_equals_jax(seed):
    from meshclust2_tpu.utils.lcs import lcs_length as jax_lcs

    rng = np.random.default_rng(seed)
    a = random_dna(rng, int(rng.integers(1, 300)))
    b = mutated(rng, a, 0.3) or "A"
    windows = [{}, dict(start1=len(a) // 3, end1=len(a) - 1, start2=0,
                        end2=len(b) // 2)]
    for w in windows:
        assert lcs_length(a, b, **w) == jax_lcs(a, b, **w)
    assert lcs_length(a.encode(), np.frombuffer(b.encode(), np.uint8)) == \
        jax_lcs(a.encode(), np.frombuffer(b.encode(), np.uint8))
    with pytest.raises(ValueError) as p:
        lcs_length(a, b, start1=2, end1=1)
    with pytest.raises(ValueError) as j:
        jax_lcs(a, b, start1=2, end1=1)
    assert str(p.value) == str(j.value)


def test_global_align_identity_golden(fixtures_dir):
    """The reference binary's alignments (the JAX test's tolerance on the
    identity), and the JAX function's four values exactly."""
    from meshclust2_tpu.utils.align import global_align_identity as jax_align

    n = 0
    with open(os.path.join(fixtures_dir, "align_golden.tsv")) as f:
        for line in f:
            a, b, score, length, ident = line.rstrip("\n").split("\t")
            got = global_align_identity(a, b)
            assert got == jax_align(a, b)
            assert got[0] == int(score) and got[1] == int(length)
            assert abs(got[3] - float(ident)) < 1e-12
            n += 1
    assert n > 0


@pytest.mark.parametrize("seed", range(3))
def test_global_align_identity_equals_jax(seed):
    from meshclust2_tpu.utils.align import global_align_identity as jax_align

    rng = np.random.default_rng(100 + seed)
    for rate in (0.0, 0.1, 0.4):
        a = random_dna(rng, int(rng.integers(5, 400)))
        b = mutated(rng, a, rate) or "C"
        for params in ({}, dict(match=2, mismatch=-3, gap_open=5, gap_continue=2)):
            assert global_align_identity(a, b, **params) == jax_align(a, b, **params)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int64])
def test_raw_histogram_equals_jax(dtype):
    from meshclust2_tpu.kmer.histogram import RawHistogram as JaxHistogram

    rng = np.random.default_rng(5)
    a0 = rng.integers(0, 100, 64)
    b0 = rng.integers(0, 100, 48)
    got = []
    for cls in (RawHistogram, JaxHistogram):
        h, g = cls(a0, dtype=dtype), cls(b0, dtype=dtype)
        vals = [h.magnitude(), h.distance(g), h.strictly_less(g),
                cls([0] * 4, dtype=dtype).strictly_less(g)]
        h.add(g).scale(0.7)
        vals.append(h.points.copy())
        h.divide(3.0).add_one()
        vals.append(h.points.copy())
        c = h.clone().sub_one()
        vals += [c.points.copy(), h.points.copy(), g.clone().zero().points.copy()]
        vals.append(cls(7, dtype=dtype).points.copy())
        vals.append(cls(3).set(g).points.copy())
        got.append(vals)
    for p, j in zip(*got):
        if isinstance(p, np.ndarray):
            assert p.dtype == j.dtype and np.array_equal(p, j)
        else:
            assert p == j


@pytest.mark.parametrize("order", [0, 1, 2, 3])
def test_markov_random_chromosome_equals_jax(order):
    from meshclust2_tpu.red.random_chrom import markov_random_chromosome as jax_mrc

    rng = np.random.default_rng(order)
    base = random_dna(rng, 3000, "ACGTACGTACGTRYN")
    segments = [(0, 999), (1010, 1012), (1100, 2999)]
    for seed in (1, 2):
        got = markov_random_chromosome(base, segments, order, seed=seed)
        assert got == jax_mrc(base, segments, order, seed=seed)
        assert len(got) == len(base)

    def lcg():
        """A caller's own generator (the C rand() recurrence)."""
        state = [12345]

        def draw():
            state[0] = (1103515245 * state[0] + 12345) % 2**31
            return state[0]
        return draw

    assert markov_random_chromosome(base, segments, order, unread="X", rng=lcg()) == \
        jax_mrc(base, segments, order, unread="X", rng=lcg())


def test_markov_random_chromosome_errors_equal_jax():
    from meshclust2_tpu.red.random_chrom import markov_random_chromosome as jax_mrc

    for args in (("ACGT", [(0, 3)], -1), ("AC*GTACGT", [(0, 8)], 3)):
        with pytest.raises(ValueError) as p:
            markov_random_chromosome(*args, seed=0)
        with pytest.raises(ValueError) as j:
            jax_mrc(*args, seed=0)
        assert str(p.value) == str(j.value)


def test_profile_flag_default_dir():
    args = torch_cli.build_parser().parse_args(["--profile"])
    assert args.profile == "/tmp/mc2_profile"
    assert torch_cli.build_parser().parse_args([]).profile is None


def test_profile_writes_a_trace_and_leaves_the_run_alone(fixtures_dir, tmp_path,
                                                         capsys):
    """--profile DIR --device cpu: a Chrome trace of CPU operator events in
    DIR and the closing line; the CLSTR byte for byte, the Clock stamps and
    the engine's counters those of the run without it."""
    runs = {}
    for name in ("plain", "profiled"):
        out = tmp_path / f"{name}.clstr"
        argv = ["--device", "cpu", "--recover",
                os.path.join(fixtures_dir, "small_ref_weights.txt"),
                "--output", str(out), os.path.join(fixtures_dir, "small.fasta")]
        if name == "profiled":
            argv[:0] = ["--profile", str(tmp_path / "prof")]
        capsys.readouterr()
        res = torch_cli.run(argv)
        assert res.rc == 0
        runs[name] = (out.read_bytes(), list(res.clock.stamps),
                      vars(res.engine.stats), capsys.readouterr().out)
    assert runs["plain"][:3] == runs["profiled"][:3]
    assert runs["profiled"][3].splitlines()[-1] == \
        f"profile trace written to {tmp_path / 'prof'}"
    assert "profile trace" not in runs["plain"][3]
    traces = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    assert ops
    assert not [e for e in events if e.get("cat") == "kernel"]


def test_console_scripts_and_package_data_name_the_port():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        meta = tomllib.load(f)
    scripts = meta["project"]["scripts"]
    want = {"meshclust2-torch": "meshclust2_tpu_torch.cli:_entry",
            "fastcar-torch": "meshclust2_tpu_torch.fastcar:_entry",
            "red-torch": "meshclust2_tpu_torch.red.cli:_entry"}
    assert {k: scripts[k] for k in want} == want
    for target in want.values():
        mod, fn = target.split(":")
        assert callable(getattr(importlib.import_module(mod), fn))
    from meshclust2_tpu_torch import native

    patterns = meta["tool"]["setuptools"]["package-data"]["meshclust2_tpu_torch.native"]
    shipped = {os.path.basename(p) for pat in patterns
               for p in glob.glob(os.path.join(os.path.dirname(native.__file__), pat))}
    assert {os.path.basename(p) for p in native._SRCS + native._HDRS} <= shipped


def package_files(pkg):
    base = os.path.join(ROOT, pkg)
    return {os.path.relpath(p, base) for ext in ("py", "cpp", "h")
            for p in glob.glob(os.path.join(base, "**", f"*.{ext}"), recursive=True)}


def test_every_module_of_the_jax_package_has_its_port():
    """Three files stay unported (ROADMAP, "Not to port"): the double-float32
    arithmetic that the port's native float64 replaces, the Pallas kernel
    that csrc/pair_stats.cu replaces, and JAX's compile-cache set-up."""
    missing = package_files("meshclust2_tpu") - package_files("meshclust2_tpu_torch")
    assert missing == {"ops/ddf32.py", "ops/pallas_stats.py", "utils/jaxconfig.py"}
