"""The port's segmented closest-to-mean against the JAX program and the host.

`closest_mean_ref` (what `closest_mean` runs on CPU tensors) must equal
`meshclust2_tpu.cluster.device_update.DeviceUpdater._closest_core` run by jax
on the CPU, exactly in `first` and `unc`, and the host engine's
`distance_d` argmin (first strict minimum) on every segment it does not
mark uncertain.  The one-segment mode (given the kept rows' column sums
and count) must equal the segmented mode on the same rows.  Tolerance:
exact throughout.  The CUDA kernel itself is held against the plain
version only on a card.
"""
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from meshclust2_tpu.cli import load_sorted_points
from meshclust2_tpu.cluster.device_update import DeviceUpdater
from meshclust2_tpu.cluster.engine import distance_d
from meshclust2_tpu_torch.ops.closest_mean import closest_mean, closest_mean_ref

torch.set_num_threads(2)

TIE_MARGIN = 1e-12


@pytest.fixture(scope="module")
def fixture_counts(fixtures_dir):
    out = {}
    for name in ("small", "med2000"):
        for dtype in ("uint8_t", "uint16_t"):
            _, ps = load_sorted_points(
                [os.path.join(fixtures_dir, f"{name}.fasta")], [], 5, dtype, False)
            np.testing.assert_array_equal(
                ps.mags, ps.counts.sum(axis=1, dtype=np.int64))
            out[name, dtype] = ps.counts
    return out


def random_counts(seed, n, d, dtype):
    high = np.iinfo(dtype).max + 1
    return np.random.default_rng(seed).integers(0, high, (n, d)).astype(dtype)


def segments(rng, n_rows, n_segs, with_dups):
    """Ragged nondecreasing segments over random rows: some empty, some of
    one row, and (with_dups) rows repeated inside a segment."""
    sizes = rng.integers(0, 40, n_segs)
    sizes[rng.choice(n_segs, n_segs // 6, replace=False)] = 0
    sizes[rng.choice(n_segs, n_segs // 6, replace=False)] = 1
    seg = np.repeat(np.arange(n_segs), sizes)
    rows = rng.integers(0, n_rows, len(seg))
    if with_dups:
        # copy some rows onto a later position of the same segment
        for p in rng.choice(len(seg) - 1, len(seg) // 8, replace=False):
            if seg[p + 1] == seg[p]:
                rows[p + 1] = rows[p]
    keep = rng.random(len(seg)) < 0.8
    return rows.astype(np.int64), seg.astype(np.int64), keep


def jax_closest(counts, rows, seg, keep, n_segs):
    import jax
    import jax.numpy as jnp

    # as DeviceUpdater.__init__ does
    if not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)

    mags = counts.sum(axis=1, dtype=np.int64)
    fake = SimpleNamespace(jnp=jnp, maxc=int(counts.max()),
                           ps=SimpleNamespace(n=len(counts)),
                           tie_margin=TIE_MARGIN)
    first, unc = jax.jit(
        lambda *a: DeviceUpdater._closest_core(fake, *a, n_segs))(
        jnp.asarray(counts), jnp.asarray(mags), jnp.asarray(rows),
        jnp.asarray(seg), jnp.asarray(keep))
    # an empty segment's minimum is the int64 identity; filter_closest
    # clips it to P (device_update.py:491)
    return np.minimum(np.asarray(first), len(rows)), np.asarray(unc)


def port_closest(counts, rows, seg, keep, n_segs):
    t = torch.from_numpy
    first, unc = closest_mean(
        t(counts), t(counts.sum(axis=1, dtype=np.int64).astype(np.float64)),
        t(rows), t(seg), t(keep), n_segs, maxc=int(counts.max()),
        tie_margin=TIE_MARGIN)
    assert first.dtype == torch.int64 and unc.dtype == torch.bool
    return first.numpy(), unc.numpy()


def port_closest_one(counts, rows, keep):
    """The one-segment mode, with the column sums and count it is given."""
    t = torch.from_numpy
    col_sum = counts[rows[keep]].astype(np.int64).sum(axis=0)
    first, unc = closest_mean(
        t(counts), t(counts.sum(axis=1, dtype=np.int64).astype(np.float64)),
        t(rows), None, t(keep), 1, maxc=int(counts.max()),
        tie_margin=TIE_MARGIN, col_sum=t(col_sum),
        count=torch.tensor([int(keep.sum())]))
    assert first.shape == unc.shape == (1,)
    return first.numpy(), unc.numpy()


def host_first(counts, rows, seg, keep, c):
    pos = np.nonzero((seg == c) & keep)[0]
    if len(pos) == 0:
        return len(rows)
    cg = counts[rows[pos]]
    return int(pos[int(np.argmin(distance_d(cg, cg.astype(np.float64).mean(axis=0))))])


@pytest.mark.parametrize("dtype", ["uint8_t", "uint16_t"])
@pytest.mark.parametrize("source", ["small", "med2000", "random"])
def test_equals_jax_program_and_host(fixture_counts, source, dtype):
    rng = np.random.default_rng(
        {"small": 1, "med2000": 2, "random": 3}[source] * 10 + len(dtype))
    if source == "random":
        # full-range bins (u16 sums beyond the u8 fixtures' range), D = 256
        counts = random_counts(17, 300, 256, np.dtype(dtype.removesuffix("_t")))
    else:
        counts = fixture_counts[source, dtype]
    rows, seg, keep = segments(rng, len(counts), 61, with_dups=True)
    first, unc = port_closest(counts, rows, seg, keep, 61)
    want_first, want_unc = jax_closest(counts, rows, seg, keep, 61)
    np.testing.assert_array_equal(unc, want_unc)
    np.testing.assert_array_equal(first, want_first)
    for c in range(61):
        if not unc[c]:
            assert first[c] == host_first(counts, rows, seg, keep, c), c
    assert (first == len(rows)).any() and not unc.all()


def test_exact_ties_take_the_first_position(fixture_counts):
    """A segment of one row repeated: every v ties exactly, nothing is
    uncertain, and the first kept position wins."""
    counts = fixture_counts["med2000", "uint8_t"]
    rows = np.array([5, 5, 5, 9, 9], np.int64)
    seg = np.array([0, 0, 0, 1, 1], np.int64)
    keep = np.array([False, True, True, True, True])
    first, unc = port_closest(counts, rows, seg, keep, 3)
    np.testing.assert_array_equal(first, [1, 3, 5])
    assert not unc.any()


@pytest.mark.parametrize("dtype", ["uint8_t", "uint16_t"])
@pytest.mark.parametrize("source,n_pairs", [("small", 40), ("med2000", 1),
                                            ("med2000", 3_000), ("random", 500)])
def test_one_segment_equals_segmented(fixture_counts, source, n_pairs, dtype):
    """The accumulate loop's shape: one segment, rows repeated (exact ties),
    some not kept."""
    rng = np.random.default_rng(n_pairs + len(dtype))
    if source == "random":
        counts = random_counts(5, 300, 256, np.dtype(dtype.removesuffix("_t")))
    else:
        counts = fixture_counts[source, dtype]
    rows = rng.integers(0, len(counts), n_pairs).astype(np.int64)
    rows[1::9] = rows[::9][:len(rows[1::9])]
    keep = rng.random(n_pairs) < 0.9
    keep[0] = True
    seg = np.zeros(n_pairs, np.int64)
    first, unc = port_closest_one(counts, rows, keep)
    want_first, want_unc = port_closest(counts, rows, seg, keep, 1)
    np.testing.assert_array_equal(first, want_first)
    np.testing.assert_array_equal(unc, want_unc)
    if not unc[0]:
        assert first[0] == host_first(counts, rows, seg, keep, 0)


def test_one_segment_without_kept_rows(fixture_counts):
    counts = fixture_counts["small", "uint8_t"]
    first, unc = port_closest_one(counts, np.array([3, 4], np.int64),
                                  np.zeros(2, bool))
    assert first[0] == 2 and not unc[0]


@pytest.mark.parametrize("case", ["count_only", "col_sum_only", "n_segs",
                                  "col_sum_shape", "count_dtype", "no_seg"])
def test_one_segment_wrapper_rejects(case):
    counts = torch.zeros((4, 16), dtype=torch.uint8)
    mags = torch.zeros(4, dtype=torch.float64)
    rows = torch.zeros(3, dtype=torch.int64)
    keep = torch.ones(3, dtype=torch.bool)
    kw = dict(col_sum=torch.zeros(16, dtype=torch.int64),
              count=torch.ones(1, dtype=torch.int64))
    n_segs = 1
    if case == "count_only":
        kw.pop("col_sum")
    elif case == "col_sum_only":
        kw.pop("count")
    elif case == "n_segs":
        n_segs = 2
    elif case == "col_sum_shape":
        kw["col_sum"] = kw["col_sum"][:8]
    elif case == "count_dtype":
        kw["count"] = kw["count"].to(torch.int32)
    elif case == "no_seg":
        kw = {}
    with pytest.raises((TypeError, ValueError)):
        closest_mean(counts, mags, rows, None, keep, n_segs, maxc=1,
                     tie_margin=1e-12, **kw)


@pytest.mark.parametrize("case", ["dtype", "mags", "rows_dtype", "keep_dtype",
                                  "shape", "lengths", "contiguity"])
def test_wrapper_rejects(case):
    counts = torch.zeros((4, 16), dtype=torch.uint8)
    mags = torch.zeros(4, dtype=torch.float64)
    rows = torch.zeros(3, dtype=torch.int64)
    seg = torch.zeros(3, dtype=torch.int64)
    keep = torch.ones(3, dtype=torch.bool)
    if case == "dtype":
        counts = counts.to(torch.int32)
    elif case == "mags":
        mags = mags.to(torch.int64)
    elif case == "rows_dtype":
        rows = rows.to(torch.int32)
    elif case == "keep_dtype":
        keep = keep.to(torch.uint8)
    elif case == "shape":
        counts = counts.reshape(-1)
    elif case == "lengths":
        seg = seg[:2]
    elif case == "contiguity":
        counts = torch.zeros((4, 32), dtype=torch.uint8)[:, ::2]
    with pytest.raises((TypeError, ValueError)):
        closest_mean(counts, mags, rows, seg, keep, 1, maxc=1, tie_margin=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("d", [16, 64, 256, 1024, 4096])
def test_cuda_kernel_equals_plain(d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    counts = random_counts(d, 300, d, dtype)
    rng = np.random.default_rng(d)
    rows, seg, keep = segments(rng, 300, 77, with_dups=True)
    dev = torch.device("cuda")
    args = [torch.from_numpy(a).to(dev) for a in (
        counts, counts.sum(axis=1, dtype=np.int64).astype(np.float64),
        rows, seg, keep)]
    kw = dict(maxc=int(counts.max()), tie_margin=TIE_MARGIN)
    before = closest_mean.launches
    first, unc = closest_mean(*args, 77, **kw)
    torch.cuda.synchronize()
    assert closest_mean.launches == before + 1
    want_first, want_unc = closest_mean_ref(*args, 77, **kw)
    assert torch.equal(first, want_first) and torch.equal(unc, want_unc)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("d,n_pairs", [(16, 1), (64, 700), (1024, 20_000), (4096, 2_000)])
def test_cuda_one_segment_equals_plain_and_segmented(d, n_pairs, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    counts = random_counts(d, 300, d, dtype)
    rng = np.random.default_rng(n_pairs)
    rows = rng.integers(0, 300, n_pairs).astype(np.int64)
    rows[1::9] = rows[::9][:len(rows[1::9])]
    keep = rng.random(n_pairs) < 0.9
    dev = torch.device("cuda")
    args = [torch.from_numpy(a).to(dev) for a in (
        counts, counts.sum(axis=1, dtype=np.int64).astype(np.float64), rows)]
    keep_d = torch.from_numpy(keep).to(dev)
    one = dict(col_sum=torch.from_numpy(
        counts[rows[keep]].astype(np.int64).sum(axis=0)).to(dev),
        count=torch.tensor([int(keep.sum())], device=dev))
    kw = dict(maxc=int(counts.max()), tie_margin=TIE_MARGIN)
    before = closest_mean.launches
    got = closest_mean(*args, None, keep_d, 1, **kw, **one)
    seg = closest_mean(*args, torch.zeros(n_pairs, dtype=torch.int64, device=dev),
                       keep_d, 1, **kw)
    torch.cuda.synchronize()
    assert closest_mean.launches == before + 2
    plain = closest_mean_ref(*args, None, keep_d, 1, **kw, **one)
    for g, s_, p in zip(got, seg, plain):
        assert torch.equal(g, s_) and torch.equal(g, p)
