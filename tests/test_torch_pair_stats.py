"""The port's pair statistics against the JAX Pallas kernel and an int64
oracle.

`pair_stats_ref` (what `pair_stats` runs on CPU tensors) must equal
`meshclust2_tpu.ops.pallas_stats.center_block_stats` in interpret mode, as
tests/test_pallas_stats.py runs it, and a numpy int64 oracle, exactly.  The
CUDA kernel itself is held against the plain version only on a card.
"""
import os

import numpy as np
import pytest
import torch

from meshclust2_tpu.io.fasta import read_fasta
from meshclust2_tpu.kmer.counting import build_point_set
from meshclust2_tpu.ops.pallas_stats import center_block_stats as jax_center_block_stats
from meshclust2_tpu_torch.ops.pair_stats import (
    center_block_stats,
    pair_stats,
    pair_stats_ref,
)

torch.set_num_threads(2)

K_OF_D = {16: 2, 256: 4, 1024: 5}


def oracle(counts, a, b):
    h = counts[a].astype(np.int64)
    c = counts[b].astype(np.int64)
    return np.stack([
        np.minimum(h, c).sum(axis=1),
        (h * c).sum(axis=1),
        np.abs(np.cumsum(h - c, axis=1)).sum(axis=1),
    ], axis=1)


def pairs_counts(fixtures_dir, d, dtype):
    recs = read_fasta(os.path.join(fixtures_dir, "pairs.fasta"))
    ps = build_point_set(recs, K_OF_D[d], {np.uint8: "uint8_t",
                                           np.uint16: "uint16_t"}[dtype])
    return ps.counts


def random_counts(seed, n, d, dtype, high):
    return np.random.default_rng(seed).integers(0, high, (n, d)).astype(dtype)


@pytest.mark.parametrize("d", [16, 256, 1024])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("source", ["pairs", "random"])
def test_center_form_equals_jax_kernel(fixtures_dir, source, dtype, d):
    if source == "pairs":
        counts = pairs_counts(fixtures_dir, d, dtype)
    else:
        # inside the JAX kernel's int32 envelope (dot < 2^31)
        high = 256 if dtype == np.uint8 else 1000
        counts = random_counts(d, 21, d, dtype, high)
    block = np.arange(1, len(counts))          # ragged against tile_b=8
    center = 0
    want = jax_center_block_stats(counts[block], counts[center], tile_b=8,
                                  interpret=True).astype(np.int64)
    np.testing.assert_array_equal(want, oracle(counts, block, np.full(len(block), center)))
    got = center_block_stats(torch.from_numpy(counts[block]),
                             torch.from_numpy(counts[center]))
    assert got.dtype == torch.int64 and got.shape == (len(block), 3)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d", [16, 256, 1024])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_pair_form_equals_oracle(fixtures_dir, dtype, d):
    counts = np.concatenate([
        pairs_counts(fixtures_dir, d, dtype),
        # full-range rows: sums beyond 2^31 need the int64 accumulation
        random_counts(d + 1, 40, d, dtype, np.iinfo(dtype).max + 1),
    ])
    rng = np.random.default_rng(7 + d)
    p = 77                                      # ragged
    a = rng.integers(0, len(counts), p)
    b = rng.integers(0, len(counts), p)
    got = pair_stats(torch.from_numpy(counts), torch.from_numpy(a),
                     torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), oracle(counts, a, b))
    # on the fixture rows (inside the JAX kernel's int32 envelope) each
    # row-vs-row stat equals the JAX kernel's center form for that pair
    fixture = pairs_counts(fixtures_dir, d, dtype)
    n = len(fixture)
    for i in (0, 5):
        want = jax_center_block_stats(fixture, fixture[i], tile_b=8,
                                      interpret=True)
        got = pair_stats(torch.from_numpy(fixture), torch.arange(n),
                         torch.full((n,), i, dtype=torch.int64))
        np.testing.assert_array_equal(got.numpy(), want)


def test_empty_pairs():
    counts = torch.zeros((3, 16), dtype=torch.uint8)
    idx = torch.zeros(0, dtype=torch.int64)
    assert pair_stats(counts, idx, idx).shape == (0, 3)


@pytest.mark.parametrize("case", ["dtype", "idx_dtype", "shape", "idx_shape",
                                  "lengths", "contiguity"])
def test_wrapper_rejects(case):
    counts = torch.zeros((4, 16), dtype=torch.uint8)
    a = torch.zeros(3, dtype=torch.int64)
    b = torch.zeros(3, dtype=torch.int64)
    if case == "dtype":
        counts = counts.to(torch.int32)
    elif case == "idx_dtype":
        a = a.to(torch.int32)
    elif case == "shape":
        counts = counts.reshape(-1)
    elif case == "idx_shape":
        a = a.reshape(3, 1)
    elif case == "lengths":
        b = b[:2]
    elif case == "contiguity":
        counts = torch.zeros((4, 32), dtype=torch.uint8)[:, ::2]
    with pytest.raises((TypeError, ValueError)):
        pair_stats(counts, a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("d", [16, 64, 256, 1024, 4096])
def test_cuda_kernel_equals_plain(d, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    counts = random_counts(d, 300, d, dtype, np.iinfo(dtype).max + 1)
    rng = np.random.default_rng(d)
    a = rng.integers(0, 300, 1001)
    b = rng.integers(0, 300, 1001)
    dev = torch.device("cuda")
    c_d = torch.from_numpy(counts).to(dev)
    a_d = torch.from_numpy(a).to(dev)
    b_d = torch.from_numpy(b).to(dev)
    before = pair_stats.launches
    got = pair_stats(c_d, a_d, b_d)
    torch.cuda.synchronize()
    assert pair_stats.launches == before + 1
    assert torch.equal(got, pair_stats_ref(c_d, a_d, b_d))
    np.testing.assert_array_equal(got.cpu().numpy(), oracle(counts, a, b))
