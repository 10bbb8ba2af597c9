"""csrc/window_select.cu (ops/window_select.py: the accumulate step's window,
and the seed before it, in one launch) against its plain twin,
TorchDeviceAccumulator._window_ops after `_seed` (cluster/device_loop.py).

- On the CPU the .cu is built by g++ against tests/coop_emu, an emulation
  of a cooperative grid (a warp 32 std::threads, the blocks taking turns
  between grid barriers), and driven through ops/window_select.py's
  argument block: on med2000's pool (bins of 37, one block) and on seeded
  pools of 12,000 rows (bins of 1,000: three blocks, and two blocks of 32
  positions a thread where the emulated card holds only two) and of 30,000
  (eight blocks).
- On the card (marked cuda) WindowSelect itself on the 10k and 100k
  shapes of the benchmark's pools (bins of 1,000).

Each case starts the twin and the kernel from copies of one state and
compares, bit for bit, the read, cand[:W], the ranks (crank) and, after a
seed, alive, assign, astep, members and msum: windows at random centers
with and without a trip, seeds, at four keep fractions, with the first and
last bins emptied, the 2^40 key clamp, an empty window (W = 0), the
largest window (every alive row but the last of the back bin: the window's
end is exclusive), an empty pool, a seed that empties the pool, uint16
counts, and the own candidates of two row blocks (with their seeds' msum
zero where the block lacks the row) against
ShardedAccumulator._window_extra.  Tolerance: exact throughout.
"""
import ctypes
import os
import shutil
import subprocess
import types

import numpy as np
import pytest
import torch

from meshclust2_tpu_torch.cli import load_sorted_points
from meshclust2_tpu_torch.cluster.bvec import BVec
from meshclust2_tpu_torch.cluster.device_loop import TorchDeviceAccumulator
from meshclust2_tpu_torch.cluster.device_store import DeviceStore
from meshclust2_tpu_torch.kmer.counting import PointSet
from meshclust2_tpu_torch.model.classifier import CompiledModel
from meshclust2_tpu_torch.model.weights import load_weights
from meshclust2_tpu_torch.ops import window_select
from meshclust2_tpu_torch.ops.window_absorb import StepState
from meshclust2_tpu_torch.parallel.multihost_session import ShardedAccumulator

torch.set_num_threads(2)

TESTS = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(TESTS, "fixtures")
I64 = torch.int64
KEEPS = (0.9, 0.5, 0.1, 0.01)


def _model():
    w = load_weights(os.path.join(FIXTURES, "med2000_weights.txt"))
    return w, CompiledModel(w.classifier)


def prepared(ps, bin_size, sim, model, device):
    """An accumulator over `ps` (rows in length order) on `device`, its
    pool in bins of `bin_size`."""
    bv = BVec(ps.lengths, bin_size)
    bv.insert_all(ps.lengths)
    bv.insert_finalize(ps.lengths)
    acc = TorchDeviceAccumulator(ps, model, sim, DeviceStore.from_pointset(ps, device))
    acc.ensure_ready(bv)
    return acc


def med2000_acc(device="cpu"):
    w, model = _model()
    _, ps = load_sorted_points([os.path.join(FIXTURES, "med2000.fasta")], [], w.k,
                               w.datatype, False)
    return prepared(ps, 37, w.id_cutoff, model, device)


def seeded_acc(n, seed, device="cpu", dtype=np.uint8, same_length=False, bin_size=1000):
    """A seeded pool of n rows of lengths 800-1,499 (or all 1,000), 1,024
    counts of 1-39 each, in bins of `bin_size`."""
    w, model = _model()
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, 40, (n, 1024)).astype(dtype)
    lengths = (np.full(n, 1_000, np.int64) if same_length
               else np.sort(rng.integers(800, 1_500, n)).astype(np.int64))
    ps = PointSet(k=5, headers=[f"s{i}" for i in range(n)], counts=counts,
                  one_mers=rng.integers(1, 400, (n, 4)).astype(np.uint64), lengths=lengths,
                  mags=counts.astype(np.int64).sum(axis=1), stddevs=rng.random(n) + 0.5,
                  ids=np.arange(n))
    return prepared(ps, bin_size, w.id_cutoff, model, device)


def state_of(acc, alive: np.ndarray) -> StepState:
    """A loop state with these alive flags (the others' stamps as a run's)."""
    n, d = len(alive), acc.store.counts.shape[1]
    dev = acc.device
    assign = np.where(alive, -1, 7).astype(np.int64)
    return StepState(torch.from_numpy(alive).to(dev).clone(), torch.from_numpy(assign).to(dev),
                     torch.from_numpy(np.where(alive, 0, 3)).to(dev),
                     torch.arange(n + 1, dtype=I64, device=dev),
                     torch.full((d,), 5, dtype=I64, device=dev))


def copy_state(st: StepState) -> StepState:
    return StepState(*(t.clone() for t in st))


def twin(acc, st: StepState, center, trip=None, seed=None):
    """The plain twin from state `st` (updated in place): the window of
    `center` (its trip's last entry when a trip is given), or with seed =
    (cid, stepc) the present seed sequence, `_seed` of the first alive row
    then `_window_ops`.  Returns (read, cand[:W], crank)."""
    acc._alive, acc._assign, acc._astep, acc._members, acc._msum = st
    dev = acc.device
    if seed is not None:
        first = torch.nonzero(st.alive).view(-1)[:1].to(I64)
        acc._seed(first, *seed)
        center = first
    elif trip is not None:
        center = trip[3:]
    else:
        center = torch.tensor([center], dtype=I64, device=dev)
    rd = torch.cat(acc._window_ops(center, trip)).tolist()
    return rd, acc._cand[:rd[4]].clone(), acc._crank0.clone()


class Kernel:
    """The kernel over the accumulator's pool buffers with crank, cand, the
    read and the own candidates of its own: `WindowSelect` on a card, the
    emulated build through the same argument block on the CPU."""

    def __init__(self, acc, emu=None, rows=None, own=False):
        S = acc._s
        n = len(S["order"])
        dev = acc.device
        counts = acc.store.counts
        self.lo, self.hi = rows if rows is not None else (0, counts.shape[0])
        counts = counts[self.lo:self.hi]
        self.crank = torch.zeros(n + 1, dtype=I64, device=dev)
        self.cand = torch.zeros(n + 1, dtype=I64, device=dev)
        self.own = (torch.zeros(n + 1, dtype=I64, device=dev),
                    torch.zeros(n + 1, dtype=I64, device=dev)) if own else None
        bufs = (S["order"], S["lens"], S["key"], S["tab"], S["bin_start"], self.crank, self.cand)
        self.emu = emu
        if emu is None:
            self.sel = window_select.WindowSelect(counts, *bufs, rows=(self.lo, self.hi),
                                                  own=self.own)
            return
        self.rd = torch.zeros(8, dtype=I64)
        self.part = torch.zeros(4 * 1024, dtype=I64)
        self.args = window_select._Args(
            counts=counts.data_ptr(), d=counts.shape[1], size=counts.element_size(), n=n,
            nb=len(S["bin_start"]) - 1, order=S["order"].data_ptr(), lens=S["lens"].data_ptr(),
            key=S["key"].data_ptr(), tab=S["tab"].data_ptr(),
            bin_start=S["bin_start"].data_ptr(), crank=self.crank.data_ptr(),
            cand=self.cand.data_ptr(), row_lo=self.lo, row_hi=self.hi, extras=int(own),
            own_pos=self.own[0].data_ptr() if own else None,
            own_rows=self.own[1].data_ptr() if own else None, rd=self.rd.data_ptr(),
            part=self.part.data_ptr(), device=0)

    def __call__(self, st: StepState, center, trip=None, seed=None):
        """As `twin`; returns (read, cand[:W], crank, own read or None)."""
        dev = st.alive.device
        if self.emu is None:
            self.sel.bind(*st)
            if seed is not None:
                rd = self.sel.seed(*seed)
            elif trip is not None:
                rd = self.sel.window(trip.data_ptr() + 24, trip.data_ptr())
            else:
                c = torch.tensor([center], dtype=I64, device=dev)
                rd = self.sel.window(c.data_ptr())
            rd = rd.tolist()
        else:
            a = self.args
            a.alive, a.assign, a.astep, a.members, a.msum = (t.data_ptr() for t in st)
            c = torch.tensor([center], dtype=I64)
            ptr = (None if seed is not None else trip.data_ptr() + 24 if trip is not None
                   else c.data_ptr())
            cid, stepc = seed if seed is not None else (0, 0)
            rc = self.emu.mc2_window_select(ctypes.addressof(a), ptr,
                                            trip.data_ptr() if trip is not None else None,
                                            int(seed is not None), cid, stepc)
            assert rc == 0
            rd = self.rd[:8 if self.own is not None else 7].tolist()
        own = None
        if self.own is not None:
            k = rd[7]
            own = (k, self.own[0][:k].clone(), self.own[1][:k].clone())
        return rd[:7], self.cand[:rd[4]].clone(), self.crank.clone(), own


def want_own(acc, kern: Kernel, cand):
    """ShardedAccumulator._window_extra on the twin's window, for the
    block [kern.lo, kern.hi)."""
    S = acc._s
    n = len(S["order"])
    dev = acc.device
    ns = types.SimpleNamespace(
        _own=(S["order"] >= kern.lo) & (S["order"] < kern.hi), _s=S,
        _own_pos=torch.zeros(n + 1, dtype=I64, device=dev),
        _own_rows=torch.zeros(n + 1, dtype=I64, device=dev),
        rows=types.SimpleNamespace(lo=kern.lo, hi=kern.hi))
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[cand] = True
    (k,) = ShardedAccumulator._window_extra(ns, mask, torch.cumsum(mask, 0, dtype=I64))
    k = int(k)
    return k, ns._own_pos[:k], ns._own_rows[:k]


def check(acc, kern: Kernel, st: StepState, center=0, trip=None, seed=None):
    """The kernel against the twin from copies of `st`; returns the read."""
    a, b = copy_state(st), copy_state(st)
    rd, cand, crank = twin(acc, a, center, trip, seed)
    got_rd, got_cand, got_crank, own = kern(b, center, trip, seed)
    assert got_rd == rd, (center, seed)
    assert torch.equal(got_cand, cand) and torch.equal(got_crank, crank)
    if seed is not None and not kern.lo <= int(acc._s["order"][rd[3]]) < kern.hi:
        a.msum.zero_()   # a row block's seed: msum only where the block holds the row
    for name, x, y in zip(StepState._fields, b, a):
        assert torch.equal(x, y), name
    if own is not None:
        k, pos, rows = want_own(acc, kern, cand)
        assert own[0] == k and torch.equal(own[1], pos) and torch.equal(own[2], rows)
    return rd


def pool_cases(acc, kern: Kernel, rng, keeps=KEEPS, centers=4, edges=False):
    """Windows at random centers (every other one through a trip) and a
    seed, at each keep fraction; with `edges`, the first and last bins
    emptied too.  Returns the reads."""
    n = len(acc._s["order"])
    bs = acc._ready[0]["bin_start"]
    reads = []
    for keep in keeps:
        alive = rng.random(n) < keep
        if edges:
            alive[:bs[1]] = False
            alive[bs[-2]:] = False
        st = state_of(acc, alive)
        for j, cur in enumerate(rng.integers(0, n, centers)):
            trip = None
            if j % 2:
                trip = torch.tensor([int(rng.integers(0, 4)), int(rng.integers(0, 9)),
                                     int(rng.integers(0, 2)), int(cur)], dtype=I64,
                                    device=acc.device)
            reads.append(check(acc, kern, st, int(cur), trip))
        if alive.any():
            reads.append(check(acc, kern, st, seed=(int(rng.integers(0, 99)),
                                                    int(rng.integers(1, 5 * n)))))
    return reads


def special_cases(acc, kern: Kernel, rng):
    """The 2^40 key clamp, an empty window, an empty pool and a seed that
    empties the pool."""
    S = acc._s
    n = len(S["order"])
    st = state_of(acc, rng.random(n) < 0.5)
    cur = int(rng.integers(0, n))
    tab = S["tab"]
    saved = tab[cur].clone()
    try:
        tab[cur, 1] = 1 << 41                    # elen past the key's length field
        clamp = check(acc, kern, st, cur)
        assert clamp[4] > 0
        tab[cur, 0] = tab[cur, 1] + 1            # blen > elen: no length passes
        assert check(acc, kern, st, cur)[4] == 0
    finally:
        tab[cur] = saved
    none = np.zeros(n, bool)
    assert check(acc, kern, state_of(acc, none), cur)[4:] == [0, 0, 0]
    one = none.copy()
    one[int(rng.integers(0, n))] = True
    assert check(acc, kern, state_of(acc, one), seed=(3, 9))[4:] == [0, 0, 0]


# -- on the CPU: the emulated build ---------------------------------------------------


@pytest.fixture(scope="module")
def emu(tmp_path_factory):
    """csrc/window_select.cu built by g++ against tests/coop_emu, with a
    launch hook that runs the kernel on the emulated grid."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ for the CPU emulation of a cooperative grid")
    csrc = os.path.join(os.path.dirname(TESTS), "meshclust2_tpu_torch", "csrc")
    tmp = str(tmp_path_factory.mktemp("select_emu"))
    src = os.path.join(tmp, "select_emu.cpp")
    with open(src, "w") as f:
        f.write('#include "window_select.cu"\n'
                'extern "C" void emu_set_capacity(int c) { emu_capacity = c; }\n'
                "static const int hooked = (emu_coop_hook = [](const void*, dim3 g, dim3 b,"
                " void** args) {\n"
                "  const SelectArgs a = *static_cast<const SelectArgs*>(args[0]);\n"
                "  emu_run(g, b, [&] { window_select_kernel(a); });\n"
                "}, 0);\n")
    so = os.path.join(tmp, "libselect_emu.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-w",
                    "-I" + os.path.join(TESTS, "coop_emu"), "-I" + csrc, "-o", so, src,
                    "-lpthread"], check=True)
    lib = ctypes.CDLL(so)
    p = ctypes.c_void_p
    lib.mc2_window_select.argtypes = [p, p, p, ctypes.c_int, ctypes.c_longlong,
                                      ctypes.c_longlong]
    lib.mc2_window_select.restype = ctypes.c_int
    lib.emu_set_capacity.argtypes = [ctypes.c_int]
    return lib


@pytest.fixture(scope="module")
def med_acc():
    return med2000_acc()


@pytest.fixture(scope="module")
def acc12k():
    return seeded_acc(12_000, 20261018)


@pytest.mark.parametrize("edges", [False, True])
def test_emulated_equals_twin_on_med2000(emu, med_acc, edges):
    reads = pool_cases(med_acc, Kernel(med_acc, emu), np.random.default_rng(1 + edges),
                       edges=edges)
    assert sum(r[4] > 0 for r in reads) > 5


@pytest.mark.parametrize("capacity,edges", [(1024, False), (1024, True), (2, False)])
def test_emulated_equals_twin_on_12k_blocks(emu, acc12k, capacity, edges):
    """Three blocks of 16 positions a thread, or two of 32 where the
    emulated card holds two blocks at once."""
    emu.emu_set_capacity(capacity)
    try:
        reads = pool_cases(acc12k, Kernel(acc12k, emu), np.random.default_rng(capacity + edges),
                           keeps=KEEPS[:3], centers=2, edges=edges)
    finally:
        emu.emu_set_capacity(1024)
    assert sum(r[4] > 100 for r in reads) > 3


@pytest.mark.parametrize("edges", [False, True])
def test_emulated_equals_twin_on_30k_eight_blocks(emu, edges):
    """30,000 rows: eight blocks, the last one short, and windows that
    span several blocks."""
    acc = seeded_acc(30_000, 17, bin_size=3_000)
    reads = pool_cases(acc, Kernel(acc, emu), np.random.default_rng(3 + edges),
                       keeps=(0.9, 0.3), centers=3, edges=edges)
    assert sum(r[4] > 1_000 for r in reads) > 2


def test_emulated_special_cases(emu, med_acc, acc12k):
    for acc in (med_acc, acc12k):
        special_cases(acc, Kernel(acc, emu), np.random.default_rng(7))


def test_emulated_largest_window(emu):
    """One bin of equal lengths, all alive: the window holds every row but
    the last (the bvec's window end is exclusive); after a seed every row
    but the seed and the last."""
    acc = seeded_acc(5_000, 3, same_length=True, bin_size=5_000)
    kern = Kernel(acc, emu)
    st = state_of(acc, np.ones(5_000, bool))
    assert check(acc, kern, st, 2_500)[4:] == [4_999, 1, 5_000]
    assert check(acc, kern, st, seed=(1, 2))[3:] == [0, 4_998, 1, 4_999]


def test_emulated_uint16_and_own_blocks(emu):
    """uint16 counts; the own candidates of two row blocks, and a seed's
    msum zero in the block that lacks its row."""
    acc = seeded_acc(9_000, 11, dtype=np.uint16)
    rng = np.random.default_rng(5)
    for rows in ((0, 4_500), (4_500, 9_000)):
        kern = Kernel(acc, emu, rows=rows, own=True)
        reads = pool_cases(acc, kern, rng, keeps=(0.7, 0.2), centers=2)
        assert any(r[4] > 0 for r in reads)


# -- on the card ---------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [10_000, 100_000])
def test_cuda_equals_twin(n):
    """WindowSelect on the benchmark's shapes: every case above but the
    emulated capacity."""
    dev = _card()
    acc = seeded_acc(n, n, device=dev)
    kern = Kernel(acc)
    rng = np.random.default_rng(n + 1)
    reads = pool_cases(acc, kern, rng, centers=6) + pool_cases(acc, kern, rng, edges=True)
    assert sum(r[4] > 100 for r in reads) > 5
    special_cases(acc, kern, rng)
    for rows in ((0, n // 2), (n // 2, n)):
        pool_cases(acc, Kernel(acc, rows=rows, own=True), rng, keeps=(0.7, 0.2), centers=4)


@pytest.mark.cuda
def test_cuda_largest_window_and_uint16():
    dev = _card()
    acc = seeded_acc(20_000, 3, device=dev, same_length=True, bin_size=20_000)
    kern = Kernel(acc)
    st = state_of(acc, np.ones(20_000, bool))
    assert check(acc, kern, st, 10_000)[4:] == [19_999, 1, 20_000]
    assert check(acc, kern, st, seed=(1, 2))[3:] == [0, 19_998, 1, 19_999]
    acc16 = seeded_acc(10_000, 4, device=dev, dtype=np.uint16)
    pool_cases(acc16, Kernel(acc16), np.random.default_rng(9), centers=2)
    assert window_select.WindowSelect.launches > 0
