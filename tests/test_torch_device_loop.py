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


def set_state(acc, alive):
    """The loop state of a pool with these alive flags (the dead rows in
    cluster 7 at stamp 3, the member list and msum filled with junk)."""
    n, d = len(alive), acc.store.counts.shape[1]
    acc._alive = torch.from_numpy(alive).clone()
    acc._assign = torch.from_numpy(np.where(alive, -1, 7).astype(np.int64))
    acc._astep = torch.from_numpy(np.where(alive, 0, 3).astype(np.int64))
    acc._members = torch.arange(n + 1, dtype=torch.int64)
    acc._msum = torch.full((d,), 5, dtype=torch.int64)


def state_copy(acc):
    return [t.clone() for t in (acc._alive, acc._assign, acc._astep, acc._members,
                                acc._msum)]


def host_window(ps, order, bin_start, bounds, alive, sim, cur):
    """The host BVec's window of flat position cur over the alive rows
    (cluster/engine.py:221-236): its rows in flat order and whether the
    window exists."""
    pool = BVec(ps.lengths, 37)
    pool.begin_bounds = list(bounds)
    pool._bounds_arr = np.asarray(pool.begin_bounds, dtype=np.int64)
    pool._lengths = np.asarray(ps.lengths, dtype=np.int64)
    pool.bins = [order[b0:b1][alive[b0:b1]] for b0, b1 in
                 zip(bin_start[:-1], bin_start[1:])]
    pool.marks = [np.zeros(len(b), bool) for b in pool.bins]
    length = int(ps.lengths[order[cur]])
    begin, end = int(length * sim), int(length / sim)
    front, back, back_empty = pool.get_range(begin, end)
    rows = np.zeros(0, np.int64) if back_empty else pool.window(front, back)[0]
    lens = ps.lengths[rows]
    return rows[(lens >= begin) & (lens <= end)], len(rows) > 0


@pytest.mark.parametrize("keep", [0.9, 0.5, 0.1, 0.01])
@pytest.mark.parametrize("edges", [False, True])
def test_seed_window_equals_seed_then_window_ops(med_acc, keep, edges):
    """The plain twin's seed mode (`_seed_window`, what a step without
    candidates runs on the CPU) against the present sequence: the first
    alive row through `_seed`, then `_window_ops` of it.  The read,
    `_cand[:W]` and the state after the seed are equal, the seed's stamps
    and msum are its own, and the window is the host BVec's; with `edges`
    the first and last bins are empty."""
    acc, ps, bv, sim = med_acc
    host = acc._ready[0]
    order, bin_start = host["order"], host["bin_start"]
    rng = np.random.default_rng(int(keep * 100) + edges)
    n = ps.n
    for _ in range(3):
        alive = rng.random(n) < keep
        if edges:
            alive[:bin_start[1]] = False
            alive[bin_start[-2]:] = False
        if not alive.any():
            alive[rng.integers(0, n)] = True
        set_state(acc, alive)
        acc._window(torch.tensor([int(rng.integers(0, n))]), None)  # the step before
        start = state_copy(acc)
        cid, stepc = int(rng.integers(1, 50)), int(rng.integers(2, 4 * n))
        cur_d, got = acc._seed_window(cid, stepc)
        after, cand = state_copy(acc), acc._cand[:got[4]].clone()

        acc._alive, acc._assign, acc._astep, acc._members, acc._msum = start
        first = int(np.flatnonzero(alive)[0])
        seed = torch.tensor([first])
        acc._seed(seed, cid, stepc)
        want = torch.cat(acc._window_ops(seed, None)).tolist()
        assert got == tuple(want[:7]) and int(cur_d) == first == got[3]
        assert torch.equal(cand, acc._cand[:want[4]])
        for x, y in zip(after, state_copy(acc)):
            assert torch.equal(x, y)
        alive_t, assign, astep, members, msum = after
        assert not alive_t[first] and int(assign[first]) == cid
        assert int(astep[first]) == stepc and int(members[0]) == first
        assert torch.equal(msum, torch.from_numpy(
            ps.counts[order[first]].astype(np.int64)))
        alive[first] = False
        rows, have = host_window(ps, order, bin_start, bv.begin_bounds, alive, sim, first)
        np.testing.assert_array_equal(order[cand.numpy()], rows)
        assert got[4:] == (len(rows), int(have), int(alive.sum()))


def test_seed_window_one_row_pool(fixtures_dir):
    """A pool of one row: the seed takes it, and the window of a pool that
    is empty reads W = 0, no window, total 0."""
    w = load_weights(os.path.join(fixtures_dir, "med2000_weights.txt"))
    _, ps = load_sorted_points([os.path.join(fixtures_dir, "med2000.fasta")],
                               [], w.k, w.datatype, False)
    one = ps.subset(np.array([700]))
    bv = BVec(one.lengths, 37)
    bv.insert_all(one.lengths)
    bv.insert_finalize(one.lengths)
    acc = TorchDeviceAccumulator(one, CompiledModel(w.classifier), w.id_cutoff,
                                 DeviceStore.from_pointset(one, "cpu"))
    acc.ensure_ready(bv)
    set_state(acc, np.ones(1, bool))
    assert acc._window(torch.tensor([0]), None) == (0, 0, 0, 0, 0, 0, 1)
    cur_d, got = acc._seed_window(4, 11)
    assert got == (0, 0, 0, 0, 0, 0, 0) and int(cur_d) == 0
    assert [int(t[0]) for t in state_copy(acc)[:4]] == [0, 4, 11, 0]
    assert torch.equal(acc._msum, torch.from_numpy(one.counts[0].astype(np.int64)))


def test_seed_window_empties_the_pool(med_acc):
    """The last alive row of a pool seeds: the pool empties (total 0)."""
    acc, ps, _, _ = med_acc
    alive = np.zeros(ps.n, bool)
    alive[1_234] = True
    set_state(acc, alive)
    acc._window(torch.tensor([5]), None)
    cur_d, got = acc._seed_window(2, 3)
    assert got[3:] == (1_234, 0, 0, 0) and int(cur_d) == 1_234
    assert not acc._alive.any() and int(acc._assign[1_234]) == 2


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
    # accumulate pairs from the accumulator, update pairs from the phase
    # (the updater's after a guarded abort); none through the scorer
    assert res.phase.last_iterations == 3
    assert s.pairs_scored == 1_892 + res.phase.scored_pairs + res.updater.scored_pairs
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
    """The plain step's closest-to-mean marking the mean uncertain from its
    20th call on: the next absorb aborts at stage 2 (absorb applied, center
    kept), the engine redoes the mean and the following steps on the host
    and relaunches from make_carry, and the output stays the host
    engine's."""
    from meshclust2_tpu_torch.ops import window_absorb

    real = window_absorb.closest_mean_ref
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

    clean_env.setattr(window_absorb, "closest_mean_ref", doubtful)
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
    assert res.phase.scored_pairs == 116_481 and res.accumulator.aborts == 0
    assert res.updater.scored_pairs == 0


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
