"""Training on the port against the JAX package (--device cpu: the kernels'
plain versions).

- TorchDeviceTableBuilder (the pair-statistics kernel in pair form, the
  float64 derive_singles and the error bound) on 500 seeded random pairs of
  small.fasta, identical rows included: after the exact-extrema re-check its
  per-single minima and maxima equal the JAX package's float64 host oracle
  (features/host.py:compute_singles) bit for bit, and every entry of the
  table lies within 8 err + 1e-12 max(|oracle|, 1) of the oracle, the
  window the re-check relies on (tests/test_training_device.py:61-97).
- `--dump` of the port equals the JAX package's `--device host --dump` on
  small.fasta (--id 0.9 --kmer 5 --mut-type single): the same selected
  combos and singles, bit-identical bounds, weights within rtol 1e-7 /
  atol 1e-9; the two files are byte-identical.
- Training then clustering without --dump: the CLSTR equals the JAX host
  engine's run with --recover and the port's weights, byte for byte.
- On the card (cuda marker): the kernel-built table against the plain one.
"""
import os

import numpy as np
import pytest
import torch

from meshclust2_tpu.features import host as jax_host
from meshclust2_tpu.model.weights import load_weights as jax_load_weights
from meshclust2_tpu_torch import cli as torch_cli
from meshclust2_tpu_torch.cluster.device_loop import DeviceLoopUnsupported
from meshclust2_tpu_torch.features import flags as F
from meshclust2_tpu_torch.io.fasta import read_fasta
from meshclust2_tpu_torch.kmer.counting import build_point_set
from meshclust2_tpu_torch.model.weights import load_weights
from meshclust2_tpu_torch.ops.device_features import _FUSED_DERIVABLE
from meshclust2_tpu_torch.ops.pair_stats import pair_stats
from meshclust2_tpu_torch.train.device_tables import (
    TableStats, TorchDeviceTableBuilder, device_raw_singles)

torch.set_num_threads(2)

FAST = F.split_flags(F.PRED_FEAT_FAST)
# every single the pair statistics derive, d2z and euclidean_z among them
DERIVABLE = sorted(_FUSED_DERIVABLE)
TRAIN_ARGS = ["--id", "0.9", "--kmer", "5", "--mut-type", "single"]


FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture(scope="module")
def small_ps():
    # the path from this file, not tests/conftest.py's fixture: the card's
    # machine runs the cuda-marked tests with --noconftest
    recs = read_fasta(os.path.join(FIXTURES, "small.fasta"))
    return build_point_set(recs, 5, "uint8_t")


def random_pairs(ps, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, ps.n, 500).astype(np.int64)
    b = rng.integers(0, ps.n, 500).astype(np.int64)
    b[::17] = a[::17]   # identical rows: the z-features cancel to zero
    return a, b


def oracle(ps, a, b, idx, singles=FAST):
    """The JAX package's float64 host formulas on the pairs idx."""
    A = jax_host.side_from_pointset(ps, a[idx])
    B = jax_host.side_from_pointset(ps, b[idx])
    return jax_host.compute_singles(singles, A, B)


@pytest.mark.parametrize("seed,singles", [(3, FAST), (4, DERIVABLE)],
                         ids=["fast", "derivable"])
def test_table_builder_exact_extrema_and_bound(small_ps, seed, singles):
    ps = small_ps
    a, b = random_pairs(ps, seed)
    want = oracle(ps, a, b, np.arange(len(a)), singles)
    stats = TableStats()
    got = device_raw_singles(
        ps, a, b, singles, lambda idx: oracle(ps, a, b, idx, singles), "cpu",
        stats)
    assert np.array_equal(got.min(axis=0), want.min(axis=0))
    assert np.array_equal(got.max(axis=0), want.max(axis=0))
    assert stats.tables == 1 and stats.pairs == 500
    assert 0 < stats.rechecked_rows < 500 and stats.launches == 0   # CPU
    # soundness of the bound the re-check relies on
    raw, err = TorchDeviceTableBuilder(ps, singles, "cpu").raw_with_err(a, b)
    assert np.all(np.abs(raw - want) <=
                  8 * err + 1e-12 * np.maximum(np.abs(want), 1.0))
    if F.FEAT_EUCLIDEAN_Z in singles:
        # where the bound has work to do: euclidean_z of identical rows,
        # for which the host sums exact zeros
        ez = singles.index(F.FEAT_EUCLIDEAN_Z)
        same = a == b
        assert np.all(want[same, ez] == 0.0)
        assert np.all(np.abs(raw[same, ez]) <= 8 * err[same, ez])


@pytest.mark.parametrize("feat", ["slow", "extraslow"])
def test_table_builder_refuses_underivable_singles(small_ps, feat):
    singles = F.split_flags(torch_cli.FEAT_SETS[feat])
    with pytest.raises(DeviceLoopUnsupported, match="not derivable"):
        TorchDeviceTableBuilder(small_ps, singles, "cpu")


def jax_host_dump(fixtures_dir, tmp_path, monkeypatch):
    from meshclust2_tpu.cli import main as jax_main

    w = tmp_path / "jax_w.txt"
    with monkeypatch.context() as m:
        m.chdir(tmp_path)
        m.delenv("MC2_DEVICE_TRAIN", raising=False)
        assert jax_main(TRAIN_ARGS + [
            "--device", "host", "--dump", str(w),
            os.path.join(fixtures_dir, "small.fasta")]) == 0
    return w


def test_dump_equals_jax_host_training(fixtures_dir, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    w = tmp_path / "port_w.txt"
    res = torch_cli.run(TRAIN_ARGS + [
        "--device", "cpu", "--dump", str(w),
        os.path.join(fixtures_dir, "small.fasta")])
    assert res.rc == 0 and res.engine is None
    assert sorted(os.listdir(tmp_path)) == ["port_w.txt"]
    # the training and testing tables, 2,200 pairs each, on the card's path
    assert res.tables.tables == 2 and res.tables.pairs == 4_400
    assert 0 < res.tables.rechecked_rows < 4_400
    assert {"data_generation", "GLM"} <= set(res.clock.stamps)
    jw = jax_host_dump(fixtures_dir, tmp_path, monkeypatch)
    port, jax = load_weights(str(w)).classifier, jax_load_weights(str(jw)).classifier
    assert port.combos == jax.combos and port.singles == jax.singles
    assert np.array_equal(np.asarray(port.mins), np.asarray(jax.mins))
    assert np.array_equal(np.asarray(port.maxs), np.asarray(jax.maxs))
    assert np.allclose(port.weights, jax.weights, rtol=1e-7, atol=1e-9)
    # beyond the criteria: the final weights come from the same float64
    # re-solve on the host's columns, so the files are byte-identical
    assert w.read_bytes() == jw.read_bytes()


def test_train_and_cluster_equals_jax_host_engine(fixtures_dir, tmp_path,
                                                  monkeypatch):
    from meshclust2_tpu.cli import main as jax_main

    monkeypatch.chdir(tmp_path)
    out = tmp_path / "port.clstr"
    res = torch_cli.run(TRAIN_ARGS + [
        "--device", "cpu", "--output", str(out),
        os.path.join(fixtures_dir, "small.fasta")])
    assert res.rc == 0 and res.trained is not None
    # a training run without --dump writes weights.txt, as the reference
    weights = tmp_path / "weights.txt"
    assert load_weights(str(weights)).classifier.combos == \
        res.trained.classifier.combos
    assert res.accumulator.total_steps > 0 and res.accumulator.error is None
    jax_out = tmp_path / "jax.clstr"
    with monkeypatch.context() as m:
        for k in ("MC2_NO_DEVICE_LOOP", "MC2_NO_DEVICE_SESSION",
                  "MC2_DEVICE_LOOP"):
            m.delenv(k, raising=False)
        assert jax_main(["--device", "host", "--recover", str(weights),
                         "--output", str(jax_out),
                         os.path.join(fixtures_dir, "small.fasta")]) == 0
    assert out.read_bytes() == jax_out.read_bytes()


@pytest.mark.cuda
def test_cuda_table_equals_plain(small_ps):
    """The kernel-built table against the plain one on the same pairs.  The
    pair statistics are equal.  The float64 epilogue may round a few
    entries differently on the card (CUDA's and the CPU's sqrt and pow
    round alike only up to an ulp; 15 of 4,500 entries differed, by at most
    1.3 ulp, on an H100): raw values and bounds agree within 4 ulps.  After
    the exact-extrema re-check the per-single minima and maxima are equal
    bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    ps = small_ps
    a, b = random_pairs(ps, 3)
    cpu = TorchDeviceTableBuilder(ps, FAST, "cpu")
    stats = TableStats()
    gpu = TorchDeviceTableBuilder(ps, FAST, "cuda", stats)
    a_d = torch.from_numpy(a)
    b_d = torch.from_numpy(b)
    assert torch.equal(
        pair_stats(gpu.store.counts, a_d.cuda(), b_d.cuda()).cpu(),
        pair_stats(cpu.store.counts, a_d, b_d))
    launches = stats.launches
    raw_c, err_c = cpu.raw_with_err(a, b)
    raw_g, err_g = gpu.raw_with_err(a, b)
    assert stats.launches == launches + 1
    ulps = 4 * np.finfo(np.float64).eps
    for g, c in ((raw_g, raw_c), (err_g, err_c)):
        assert np.all(np.abs(g - c) <= ulps * np.abs(c))
    exact = lambda idx: oracle(ps, a, b, idx)  # noqa: E731
    got = device_raw_singles(ps, a, b, FAST, exact, "cuda")
    want = device_raw_singles(ps, a, b, FAST, exact, "cpu")
    assert np.array_equal(got.min(axis=0), want.min(axis=0))
    assert np.array_equal(got.max(axis=0), want.max(axis=0))
    assert np.all(np.abs(got - want) <= ulps * np.abs(want))
