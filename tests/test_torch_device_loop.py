"""TorchDeviceAccumulator, the port's accumulate loop, against the JAX
package and the host engine (--device cpu: the kernels' plain versions).

- The window of every step (alive ranks, the bvec's in-bin search quirks,
  the length filter) equals the host BVec's get_range/window walk
  (cluster/engine.py:221-236) on random alive masks over many small bins.
- small.fasta through the port's default path equals the JAX package's
  forced sessionless device loop (--device host, MC2_DEVICE_LOOP=1) byte
  for byte, with the accumulator's steps, windows and pairs equal to the
  JAX DeviceAccumulator's.
- Forced margins (MC2_DD_MARGIN) make the loop abort; the engine resolves
  on the host and the output stays byte for byte the host engine's.
- med2000 and the 10k bench set (slow) equal their references, with the
  accumulator's counts recorded once from the JAX DeviceAccumulator: med2000
  393 steps, 146 windows, 48,737 pairs (its --device host, MC2_DEVICE_LOOP=1
  run); 10k 1,503 steps, 590 windows, 927,148 pairs (BENCH_r05.json tail).
Tolerance: exact throughout.
"""
import gzip
import os
import shutil

import numpy as np
import pytest
import torch

from meshclust2_tpu.cluster import device_loop as jax_device_loop
from meshclust2_tpu_torch import cli as torch_cli
from meshclust2_tpu_torch.cli import load_sorted_points
from meshclust2_tpu_torch.cluster.bvec import BVec
from meshclust2_tpu_torch.cluster.device_loop import TorchDeviceAccumulator
from meshclust2_tpu_torch.cluster.engine import MeanShiftEngine
from meshclust2_tpu_torch.io.clstr import parse_clstr
from meshclust2_tpu_torch.model.classifier import CompiledModel
from meshclust2_tpu_torch.model.weights import load_weights
from meshclust2_tpu_torch.cluster.device_session import TorchDeviceSession
from meshclust2_tpu_torch.cluster.device_store import DeviceStore

torch.set_num_threads(2)

DEVICE_LOOP_ENV = ("MC2_NO_DEVICE_LOOP", "MC2_NO_DEVICE_UPDATE_BATCH",
                   "MC2_NO_DEVICE_SESSION", "MC2_DEVICE_LOOP", "MC2_DD_MARGIN",
                   "MC2_DEV_MAX_RESUMES")


@pytest.fixture
def clean_env(monkeypatch):
    for k in DEVICE_LOOP_ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def port_run(fixtures_dir, tmp_path, fasta, weights, device="cpu"):
    out = tmp_path / f"port_{device}.clstr"
    res = torch_cli.run(["--device", device, "--recover",
                         os.path.join(fixtures_dir, weights), "--output",
                         str(out), os.path.join(fixtures_dir, fasta)])
    assert res.rc == 0
    return out, res


def jax_host_run(fixtures_dir, tmp_path, monkeypatch, env, fasta="small.fasta",
                 weights="small_ref_weights.txt"):
    """The JAX package's CLI with --device host under `env`; returns the
    output path and the (steps, windows, pairs) of each DeviceAccumulator
    launch it made."""
    from meshclust2_tpu.cli import main as jax_main

    launches = []
    real = jax_device_loop.DeviceAccumulator.consume

    def consume(self, *args, **kw):
        res = real(self, *args, **kw)
        launches.append((self.last_steps, self.last_windows, self.last_pairs))
        return res

    out = tmp_path / "jax.clstr"
    with monkeypatch.context() as m:
        m.setattr(jax_device_loop.DeviceAccumulator, "consume", consume)
        for k, v in env.items():
            m.setenv(k, v)
        assert jax_main(["--device", "host", "--recover",
                         os.path.join(fixtures_dir, weights), "--output",
                         str(out), os.path.join(fixtures_dir, fasta)]) == 0
    return out, launches


def acc_counts(res):
    acc = res.accumulator
    return acc.total_steps, acc.last_windows, acc.last_pairs


@pytest.fixture(scope="module")
def med_acc(fixtures_dir):
    """An accumulator over med2000 prepared for a pool of bins of 37 rows,
    with the pool's bins for the host walk."""
    w = load_weights(os.path.join(fixtures_dir, "med2000_weights.txt"))
    _, ps = load_sorted_points([os.path.join(fixtures_dir, "med2000.fasta")],
                               [], w.k, w.datatype, False)
    model = CompiledModel(w.classifier)
    bv = BVec(ps.lengths, 37)
    bv.insert_all(ps.lengths)
    bv.insert_finalize(ps.lengths)
    acc = TorchDeviceAccumulator(ps, model, w.id_cutoff,
                                 DeviceStore.from_pointset(ps, "cpu"))
    acc.ensure_ready(bv)
    return acc, ps, bv, w.id_cutoff


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_window_equals_host_bvec(med_acc, seed):
    acc, ps, bv, sim = med_acc
    host = acc._ready[0]
    order, bin_start = host["order"], host["bin_start"]
    rng = np.random.default_rng(seed)
    n = ps.n
    checked = 0
    for keep_frac in (0.9, 0.5, 0.1, 0.01):
        alive = rng.random(n) < keep_frac
        if seed == 3:
            # empty the first and last bins too: the search redirects
            alive[:bin_start[2]] = False
            alive[bin_start[-3]:] = False
        pool = BVec(ps.lengths, 37)
        pool.begin_bounds = list(bv.begin_bounds)
        pool._bounds_arr = np.asarray(pool.begin_bounds, dtype=np.int64)
        pool._lengths = np.asarray(ps.lengths, dtype=np.int64)
        pool.bins = [order[b0:b1][alive[b0:b1]] for b0, b1 in
                     zip(bin_start[:-1], bin_start[1:])]
        pool.marks = [np.zeros(len(b), bool) for b in pool.bins]
        acc._alive = torch.from_numpy(alive)
        for cur in rng.integers(0, n, 40):
            _, _, _, _, n_cand, have, total = acc._window(
                torch.tensor([cur]), None)
            got = order[acc._cand[:n_cand].numpy()]
            length = int(ps.lengths[order[cur]])
            begin, end = int(length * sim), int(length / sim)
            front, back, back_empty = pool.get_range(begin, end)
            rows = np.zeros(0, np.int64) if back_empty else \
                pool.window(front, back)[0]
            lens = ps.lengths[rows]
            want = rows[(lens >= begin) & (lens <= end)]
            np.testing.assert_array_equal(got, want)
            assert have == (len(rows) > 0) and total == alive.sum()
            checked += len(want) > 0
    assert checked > 50


def test_session_sets_the_device_loop_flag_with_an_accumulator(fixtures_dir):
    """The session's accumulator is the engine's one switch of the device
    loop: no scorer flag, and without an accumulator the engine's
    _device_accumulate returns None (the host loop runs)."""
    w = load_weights(os.path.join(fixtures_dir, "small_ref_weights.txt"))
    _, ps = load_sorted_points([os.path.join(fixtures_dir, "small.fasta")],
                               [], w.k, w.datatype, False)
    model = CompiledModel(w.classifier)
    on = TorchDeviceSession(ps, model, "cpu", w.id_cutoff)
    off = TorchDeviceSession(ps, model, "cpu", w.id_cutoff, device_loop=False)
    assert on.accumulator is not None and off.accumulator is None
    assert not hasattr(on.scorer, "prefers_device_loop")
    engine = MeanShiftEngine(ps, model, w.id_cutoff, scorer=off.scorer,
                             device_session=off)
    assert engine._device_accumulate(on.bv, None) is None


def test_small_equals_jax_device_loop(fixtures_dir, tmp_path, clean_env):
    out, res = port_run(fixtures_dir, tmp_path, "small.fasta",
                        "small_ref_weights.txt")
    jax_out, launches = jax_host_run(fixtures_dir, tmp_path, clean_env,
                                     {"MC2_DEVICE_LOOP": "1"})
    assert out.read_bytes() == jax_out.read_bytes()
    assert launches == [acc_counts(res)] == [(41, 38, 1_892)]
    assert res.accumulator.aborts == 0 and res.accumulator.error is None
    s = res.engine.stats
    assert (s.windows_scored, s.clusters_before_update) == (38, 21)
    # accumulate pairs from the accumulator, update pairs from the updater;
    # none through the scorer
    assert s.pairs_scored == 1_892 + res.updater.scored_pairs
    assert res.scorer.scored_pairs == 0


@pytest.mark.parametrize("env", [{"MC2_DD_MARGIN": "3e-3"},
                                 {"MC2_DD_MARGIN": "1e9",
                                  "MC2_DEV_MAX_RESUMES": "2"}])
def test_forced_margin_aborts_resolve_to_the_host_output(fixtures_dir, tmp_path,
                                                         clean_env, env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    out, res = port_run(fixtures_dir, tmp_path, "small.fasta",
                        "small_ref_weights.txt")
    for k in env:
        clean_env.delenv(k)
    host_out, launches = jax_host_run(fixtures_dir, tmp_path, clean_env,
                                      {"MC2_NO_DEVICE_LOOP": "1"})
    assert not launches
    assert out.read_bytes() == host_out.read_bytes()
    assert res.accumulator.aborts > 0 and res.accumulator.error is None
    assert res.accumulator.margin == float(env["MC2_DD_MARGIN"])


@pytest.mark.parametrize("fasta,weights", [
    ("small.fasta", "small_ref_weights.txt"),
    ("med2000.fasta", "med2000_weights.txt")])
def test_uncertain_closest_to_mean_aborts_at_stage_2(fixtures_dir, tmp_path,
                                                      clean_env, fasta, weights):
    """closest_mean marking the mean uncertain from its 20th launch on: the
    next absorb aborts at stage 2 (absorb applied, center kept), the
    engine redoes the mean and the following steps on the host and
    relaunches from make_carry, and the output stays the host engine's."""
    from meshclust2_tpu_torch.cluster import device_loop

    real = device_loop.closest_mean
    calls = []

    def doubtful(*args, **kw):
        first, unc = real(*args, **kw)
        calls.append(1)
        return first, unc | (len(calls) >= 20)

    stages = []
    consume = TorchDeviceAccumulator.consume

    def record(self, *args):
        out = consume(self, *args)
        stages.append(0 if out[1] is None else out[1].stage)
        return out

    clean_env.setattr(device_loop, "closest_mean", doubtful)
    clean_env.setattr(TorchDeviceAccumulator, "consume", record)
    out, res = port_run(fixtures_dir, tmp_path, fasta, weights)
    clean_env.undo()
    host_out, _ = jax_host_run(fixtures_dir, tmp_path, clean_env,
                               {"MC2_NO_DEVICE_LOOP": "1"}, fasta=fasta,
                               weights=weights)
    assert out.read_bytes() == host_out.read_bytes()
    assert stages[0] == 2 and res.accumulator.aborts == stages.count(2)
    assert res.accumulator.error is None


def test_med2000_equals_reference(fixtures_dir, tmp_path, clean_env):
    out, res = port_run(fixtures_dir, tmp_path, "med2000.fasta",
                        "med2000_weights.txt")
    with open(os.path.join(fixtures_dir, "med2000_ref.clstr")) as f:
        want = sorted(f.readlines())
    with open(out) as f:
        assert sorted(f.readlines()) == want
    s = res.engine.stats
    assert acc_counts(res) == (393, 146, 48_737)
    assert (s.windows_scored, s.pairs_scored, s.clusters_before_update,
            s.update_iterations) == (146, 48_737 + 116_481, 305, 6)
    assert res.updater.scored_pairs == 116_481 and res.accumulator.aborts == 0


@pytest.mark.slow
def test_bench10k_equals_reference(fixtures_dir, tmp_path, clean_env):
    import bench
    from tests.test_parity_10k import _signature

    fasta = tmp_path / "bench_10000.fasta"
    assert bench.N_SEQS == 10000 and bench.SEED == 424242
    bench.ensure_dataset(str(fasta))
    out, res = port_run(fixtures_dir, tmp_path, str(fasta),
                        "bench10k_weights.txt")
    ref_txt = tmp_path / "ref.clstr"
    with gzip.open(os.path.join(fixtures_dir, "bench10k_ref_t1.clstr.gz"),
                   "rb") as f, open(ref_txt, "wb") as g:
        shutil.copyfileobj(f, g)
    got = parse_clstr(str(out))
    assert len(got) == 788
    assert _signature(got) == _signature(parse_clstr(str(ref_txt)))
    s = res.engine.stats
    assert acc_counts(res) == (1_503, 590, 927_148)
    assert (s.windows_scored, s.pairs_scored, s.clusters_before_update,
            s.update_iterations) == (590, 927_148 + 708_385, 1_147, 7)


@pytest.mark.cuda
@pytest.mark.parametrize("fasta,weights,acc", [
    ("small.fasta", "small_ref_weights.txt", (41, 38, 1_892)),
    ("med2000.fasta", "med2000_weights.txt", (393, 146, 48_737))])
def test_cuda_default_path_equals_cpu(tmp_path, clean_env, fasta, weights, acc):
    """The default path on the card (the three kernels) against the plain
    versions on the CPU: the same bytes and the same accumulator counts."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    fixtures = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "fixtures")
    out_cpu, res_cpu = port_run(fixtures, tmp_path, fasta, weights)
    out_gpu, res_gpu = port_run(fixtures, tmp_path, fasta, weights,
                                device="cuda")
    assert out_gpu.read_bytes() == out_cpu.read_bytes()
    assert acc_counts(res_gpu) == acc_counts(res_cpu) == acc
    assert res_gpu.accumulator.aborts == 0
