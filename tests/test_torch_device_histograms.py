"""The port's device k-mer histogram build (parallel/mesh.py:
device_build_counts over ops/kmer_count.py; MC2_DEVICE_COUNT) against the
JAX package's sharded build (meshclust2_tpu/parallel/mesh.py:
device_build_counts, on the CPU mesh of tests/conftest.py) and the port's
native counter (native.count_kmers_batch), byte for byte, on the cases of
tests/test_device_histograms.py (random records with N runs at k = 4,
uint16; uint8 saturation; med2000[:300] at k = 5; the environment switch on
small.fasta) and on more: a record shorter than k, an all-N record, a
record over 1 Mbp (its segment split: a window across it must not count),
k = 8 (the kernel's global-histogram instantiation) and uint32.  On the
CPU `device_build_counts(..., device="cpu")` runs the kernel's plain
version, and the kernel's own source (csrc/kmer_count.cu), compiled by
g++ against a CPU emulation of warps (tests/kmer_emu), runs the cases its
design splits or packs (records longer than a piece, many records shorter
than a lane's 16 positions, homopolymers, k = 1 and k >= 8) with pieces
small enough to split them.  Marked cuda: the kernel against its plain
version on the card, and device_build_counts with device=None.
Tolerance: exact (integer counts).
"""
import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from meshclust2_tpu_torch import native
from meshclust2_tpu_torch.io.fasta import encode_sequence, read_fasta
from meshclust2_tpu_torch.kmer.counting import DTYPE_MAX, build_point_set
from meshclust2_tpu_torch.ops import kmer_count as K
from meshclust2_tpu_torch.ops.kmer_count import (kmer_count, kmer_count_ref,
                                                 kmer_windows, packed_on)
from meshclust2_tpu_torch.parallel.mesh import device_build_counts, pack_segment_codes

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def n_runs_records(seed: int = 21, n: int = 37):
    """The JAX test's records: random bases salted with runs of N."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L = int(rng.integers(40, 900))
        s = list(rng.choice(list("ACGT"), L))
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, L - 1))
            w = int(rng.integers(1, 40))
            for j in range(p, min(L, p + w)):
                s[j] = "N"
        out.append((f"r{i}", "".join(s)))
    return out


def saturation_record():
    return [("sat", "A" * 2000 + "CGTACGT" * 30)]


def long_record():
    """One record of 2,000,050 bases: two segments, split at 1 Mbp."""
    rng = np.random.default_rng(5)
    return [("long", "".join(rng.choice(list("ACGT"), 2_000_050)))]


def edge_records():
    """A record shorter than k, an all-N record, an empty one, and two
    ordinary ones around them."""
    rng = np.random.default_rng(9)
    seq = lambda n: "".join(rng.choice(list("ACGT"), n))   # noqa: E731
    return [("a", seq(300)), ("short", seq(3)), ("alln", "N" * 500), ("empty", ""),
            ("b", seq(41))]


def port_records(named):
    return [encode_sequence(h, s) for h, s in named]


def med2000(n: int = 300):
    return read_fasta(os.path.join(FIXTURES, "med2000.fasta"))[:n]


def check_port(records, k, datatype):
    """The port's plain build equals the native counter; returns it."""
    dtype_max = DTYPE_MAX[datatype]
    counts, ones = device_build_counts(records, k, dtype_max, device="cpu")
    want_c, want_o = native.count_kmers_batch(records, k, dtype_max)
    assert counts.dtype == want_c.dtype and ones.dtype == want_o.dtype == np.uint64
    np.testing.assert_array_equal(counts, want_c)
    np.testing.assert_array_equal(ones, want_o)
    return counts, ones


def check_jax(named, counts, ones, k, datatype):
    """The JAX package's sharded build of the same records equals the
    port's, widened (its int32 counts, int64 one_mers)."""
    from meshclust2_tpu.io.fasta import encode_sequence as jax_encode
    from meshclust2_tpu.parallel.mesh import device_build_counts as jax_build
    from meshclust2_tpu.parallel.mesh import pack_segment_codes as jax_pack

    jrecs = [jax_encode(h, s) for h, s in named]
    jc, jo = jax_build(jrecs, k, DTYPE_MAX[datatype])
    np.testing.assert_array_equal(jc.astype(np.int64), counts.astype(np.int64))
    np.testing.assert_array_equal(jo.astype(np.uint64), ones)
    np.testing.assert_array_equal(jax_pack(jrecs), pack_segment_codes(port_records(named)))


def test_random_records_with_n_runs_equal_jax_and_native():
    named = n_runs_records()
    counts, ones = check_port(port_records(named), 4, "uint16_t")
    assert counts.dtype == np.uint16
    check_jax(named, counts, ones, 4, "uint16_t")


def test_u8_saturation_equals_jax_and_native():
    named = saturation_record()
    counts, ones = check_port(port_records(named), 5, "uint8_t")
    assert counts.max() == 255   # the saturating case was exercised
    check_jax(named, counts, ones, 5, "uint8_t")


def test_med2000_equals_jax_and_native():
    recs = med2000()
    counts, ones = check_port(recs, 5, "uint8_t")
    from meshclust2_tpu.io.fasta import read_fasta as jax_read
    from meshclust2_tpu.parallel.mesh import device_build_counts as jax_build

    jc, jo = jax_build(jax_read(os.path.join(FIXTURES, "med2000.fasta"))[:300], 5,
                       DTYPE_MAX["uint8_t"])
    np.testing.assert_array_equal(jc.astype(np.int64), counts.astype(np.int64))
    np.testing.assert_array_equal(jo.astype(np.uint64), ones)


def test_build_point_set_device_count_env(monkeypatch):
    recs = read_fasta(os.path.join(FIXTURES, "small.fasta"))
    monkeypatch.delenv("MC2_DEVICE_COUNT", raising=False)
    host_ps = build_point_set(recs, 5, "uint8_t")
    monkeypatch.setenv("MC2_DEVICE_COUNT", "1")
    calls = []
    from meshclust2_tpu_torch.parallel import mesh

    real = mesh.device_build_counts

    def counted(*args, **kwargs):
        calls.append(kwargs["device"])
        return real(*args, **kwargs)

    monkeypatch.setattr(mesh, "device_build_counts", counted)
    dev_ps = build_point_set(recs, 5, "uint8_t", count_device="cpu")
    assert calls == ["cpu"]
    for f in ("counts", "one_mers", "mags", "stddevs"):
        a, b = getattr(host_ps, f), getattr(dev_ps, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_edge_records_equal_jax_and_native():
    named = edge_records()
    recs = port_records(named)
    assert len(recs[1].codes) < 4 and len(recs[2].segments) == 0
    counts, ones = check_port(recs, 4, "uint8_t")
    # the all-N and the empty record: pseudocounts alone
    assert (counts[2] == 1).all() and (ones[2] == 1).all() and (counts[3] == 1).all()
    check_jax(named, counts, ones, 4, "uint8_t")


def test_record_over_1mbp_skips_the_split_window():
    named = long_record()
    recs = port_records(named)
    assert recs[0].segments.tolist() == [[0, 999_999], [1_000_000, 2_000_049]]
    counts, ones = check_port(recs, 3, "uint32_t")
    assert counts.dtype == np.uint32
    # every window but the k - 1 across the split: 2,000,050 - 2 (k - 1) in all
    assert int(counts.astype(np.int64).sum()) - 64 == 2_000_050 - 2 * 2
    assert int(ones.sum()) - 4 == 2_000_050
    check_jax(named, counts, ones, 3, "uint32_t")


@pytest.mark.parametrize("k,datatype", [(8, "uint16_t"), (2, "uint32_t"), (6, "uint64_t")])
def test_k8_and_u32_equal_native(k, datatype):
    recs = med2000(60)
    counts, _ = check_port(recs, k, datatype)
    assert counts.shape == (60, 4 ** k)


def test_chunks_equal_one_build(monkeypatch):
    """Chunking over records (a chunk of at most ~2,000 codes here) gives
    the same arrays as one chunk."""
    from meshclust2_tpu_torch.parallel import mesh

    recs = port_records(n_runs_records(seed=3, n=20) + edge_records())
    whole = device_build_counts(recs, 4, 65535, device="cpu")
    monkeypatch.setitem(mesh.CHUNK_CODES, "cpu", 2_000)
    monkeypatch.setattr(mesh, "CHUNK_COUNTS", 3 * 256 * 2)
    parts = device_build_counts(recs, 4, 65535, device="cpu")
    for a, b in zip(whole, parts):
        np.testing.assert_array_equal(a, b)


def test_windows_are_the_bincount_inputs():
    """kmer_windows' flat indices, bincounted, are kmer_count_ref's raw
    counts (the library reference chip_smoke.py times)."""
    recs = port_records(n_runs_records(seed=4, n=12))
    packed = packed_on(native._pack_records(recs), "cpu")
    flat, one_idx = kmer_windows(*packed, 4)
    counts, ones = kmer_count_ref(*packed, 4, 65535)
    hist = torch.bincount(flat, minlength=len(recs) * 256).view(len(recs), 256)
    assert torch.equal(hist + 1, counts.to(torch.int64))
    assert torch.equal(torch.bincount(one_idx, minlength=4 * len(recs)).view(-1, 4) + 1,
                       ones)


def test_no_card_raises(monkeypatch):
    """device=None is the card: without one it raises, and never counts on
    the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        device_build_counts(port_records(edge_records()), 4, 255)
    monkeypatch.setenv("MC2_DEVICE_COUNT", "1")
    with pytest.raises(RuntimeError, match="is_available"):
        build_point_set(port_records(edge_records()), 4, "uint8_t")


def test_cli_device_count_equals_the_native_run(tmp_path, monkeypatch):
    """MC2_DEVICE_COUNT=1 ... cli --device cpu --recover on small.fasta:
    the same CLSTR as without it."""
    from meshclust2_tpu_torch import cli

    outs = []
    for env in (None, "1"):
        if env is None:
            monkeypatch.delenv("MC2_DEVICE_COUNT", raising=False)
        else:
            monkeypatch.setenv("MC2_DEVICE_COUNT", env)
        out = tmp_path / f"out{len(outs)}.clstr"
        res = cli.run(["--device", "cpu", "--recover",
                       os.path.join(FIXTURES, "small_ref_weights.txt"),
                       "--output", str(out), os.path.join(FIXTURES, "small.fasta")])
        assert res.rc == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and outs[0]


def long_and_tiny_records():
    """One record longer than a work item's piece (PIECE), between many
    records shorter than a lane's 16 positions, and a homopolymer over two
    pieces."""
    rng = np.random.default_rng(13)
    seq = lambda n: "".join(rng.choice(list("ACGT"), n))   # noqa: E731
    named = [(f"t{i}", seq(int(rng.integers(1, 17)))) for i in range(300)]
    named.insert(150, ("long", seq(3 * K.PIECE + 77)))
    named.append(("homo", "A" * (2 * K.PIECE + 5)))
    return named


def test_long_and_tiny_records_equal_jax_and_native():
    named = long_and_tiny_records()
    counts, ones = check_port(port_records(named), 5, "uint8_t")
    assert counts[-1, 0] == 255   # the homopolymer saturates its one bin
    check_jax(named, counts, ones, 5, "uint8_t")


def test_launch_plan():
    """Pieces of PIECE positions at the least, grown so that the split
    records' scratch stays near SCRATCH_BYTES; capped for the 16-bit shared
    counters; no scratch where no record can be split."""
    assert K.launch_plan(11_372_876, 5) == (K.PIECE, 11_372_876 // K.PIECE + 1)
    piece, rows = K.launch_plan(1 << 28, 5)
    assert piece > K.PIECE and rows * 4 * (4 ** 5 + 10) <= 2 * K.SCRATCH_BYTES
    assert K.launch_plan(1 << 28, 7)[0] == K.MAX_SHARED_PIECE
    assert K.launch_plan(1 << 20, 13) == ((1 << 20) + 1, 0)
    assert K.launch_plan(100, 5) == (K.PIECE, 0)
    assert K.SHARED_K == 7


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """csrc/kmer_count.cu built by g++ against tests/kmer_emu (its launches
    rewritten to emu_launch), loaded with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ for the CPU warp emulation")
    root = os.path.dirname(FIXTURES)
    src = open(os.path.join(os.path.dirname(root), "meshclust2_tpu_torch", "csrc",
                            "kmer_count.cu")).read()
    src = re.sub(r"(\w+(?:<[^<>]*>)?)\s*<<<(.*?)>>>\s*\(a\);",
                 lambda m: "emu_launch(%s, %s, a);" % (
                     m.group(1), ", ".join(x.strip() for x in m.group(2).split(",")[:3])),
                 src, flags=re.S)
    src = src.replace("extern __shared__ __align__(16) unsigned smem[];",
                      "unsigned* smem = emu_smem();")
    assert src.count("emu_launch(") == 2 and "emu_smem()" in src
    tmp = tmp_path_factory.mktemp("kmer_emu")
    (tmp / "kmer_count.cpp").write_text(src)
    so = tmp / "libkmer_emu.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-w",
                    "-I" + os.path.join(root, "kmer_emu"), "-o", str(so),
                    str(tmp / "kmer_count.cpp"), "-lpthread"], check=True)
    lib = ctypes.CDLL(str(so))
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.mc2_kmer_count.argtypes = [p, i64, p, p, p, i64, i64, ctypes.c_int,
                                   ctypes.c_uint64, ctypes.c_int, p, p, p, p, p, p]
    lib.mc2_kmer_count.restype = ctypes.c_int
    return lib


def aligned(n: int, dtype) -> np.ndarray:
    """An uninitialised-looking (0xAB) array of n items at a 16-byte
    address, as the caching allocator gives."""
    raw = np.full(n * np.dtype(dtype).itemsize + 16, 0xAB, np.uint8)
    at = (-raw.ctypes.data) % 16
    return raw[at:at + n * np.dtype(dtype).itemsize].view(dtype)


EMU_CASES = {"n_runs, pieces of 100": (lambda: port_records(n_runs_records(n=12)), 4,
                                       "uint16_t", 100),
             "edges, k = 1": (lambda: port_records(edge_records()), 1, "uint8_t", 64),
             "edges, k = 2, uint32": (lambda: port_records(edge_records()), 2, "uint32_t", 37),
             "tiny and long, k = 5": (lambda: port_records(long_and_tiny_records()[140:160]),
                                      5, "uint8_t", 4_000),
             "homopolymer split, k = 5": (
                 lambda: port_records([("h", "A" * 3000), ("t", "ACGT" * 5)]), 5, "uint8_t",
                 256),
             "saturation split, k = 5": (lambda: port_records(saturation_record()), 5,
                                         "uint8_t", 333),
             "k = 7 split": (lambda: port_records(n_runs_records(n=4)), 7, "uint16_t", 200),
             "k = 8, one piece": (lambda: port_records(n_runs_records(n=3)), 8, "uint16_t",
                                  8192),
             "k = 8 split": (lambda: port_records(n_runs_records(n=3)), 8, "uint16_t", 150),
             "k = 9 homopolymer, uint8": (lambda: port_records([("h", "A" * 700)]), 9,
                                          "uint8_t", 100),
             "k = 8 homopolymer, uint8, one piece (saturating CAS)": (
                 lambda: port_records([("h", "A" * 700), ("t", "ACGT" * 9)]), 8, "uint8_t",
                 8192)}


@pytest.mark.parametrize("name", list(EMU_CASES))
def test_kernel_source_on_emulated_warps_equals_plain(emulated, name):
    """The CUDA source itself, its warps emulated on the CPU, with pieces
    small enough to split records: counts and 1-mers equal the plain
    version, and the split records' scratch is zero again afterwards."""
    make, k, datatype, piece = EMU_CASES[name]
    dtype_max = DTYPE_MAX[datatype]
    codes, off, segs, soff = packed_on(native._pack_records(make()), "cpu")
    buf = aligned(codes.numel(), np.int8)
    buf[:] = codes.numpy()
    n, d = len(off) - 1, 4 ** k
    want_c, want_o = kmer_count_ref(codes, off, segs, soff, k, dtype_max)
    counts = aligned(n * d, want_c.numpy().dtype).reshape(n, d)
    ones = np.full((n, 4), -7, np.int64)
    rows = codes.numel() // piece + 1 if piece <= codes.numel() else 0
    scratch = [np.zeros((max(rows, 1), 4), np.uint64), np.zeros((max(rows, 1), d), np.uint32),
               np.zeros(max(rows, 1), np.int32)]
    idx = [t.numpy() for t in (off, segs, soff)]
    rc = emulated.mc2_kmer_count(
        buf.ctypes.data, codes.numel(), idx[0].ctypes.data, idx[1].ctypes.data,
        idx[2].ctypes.data, n, piece, k, K.saturation(dtype_max), counts.itemsize,
        counts.ctypes.data, ones.ctypes.data,
        *[t.ctypes.data if rows else None for t in scratch], None)
    assert rc == 0
    assert rows == 0 or any(int(off[r + 1] - off[r]) > piece for r in range(n))
    np.testing.assert_array_equal(counts, want_c.numpy())
    np.testing.assert_array_equal(ones, want_o.numpy())
    assert not any(t.any() for t in scratch)


def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


CUDA_CASES = {"n_runs": (lambda: port_records(n_runs_records()), 4, "uint16_t"),
              "saturation": (lambda: port_records(saturation_record()), 5, "uint8_t"),
              "med2000": (lambda: med2000(), 5, "uint8_t"),
              "edges": (lambda: port_records(edge_records()), 4, "uint8_t"),
              "over_1mbp": (lambda: port_records(long_record()), 3, "uint32_t"),
              "k8": (lambda: med2000(200), 8, "uint16_t"),
              "k9": (lambda: med2000(40), 9, "uint8_t"),
              "long_and_tiny": (lambda: port_records(long_and_tiny_records()), 5, "uint8_t"),
              "long_and_tiny_k8": (lambda: port_records(long_and_tiny_records()), 8,
                                   "uint16_t"),
              "homopolymer_k1": (lambda: port_records([("h", "A" * 100_000)]), 1,
                                 "uint32_t")}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_CASES))
def test_cuda_kmer_count_equals_plain_and_native(name):
    """The kernel against its plain version on the card and the native
    counter, byte for byte; k >= 8 through the global instantiation."""
    dev = cuda_device()
    make, k, datatype = CUDA_CASES[name]
    recs = make()
    dtype_max = DTYPE_MAX[datatype]
    packed = packed_on(native._pack_records(recs), dev)
    kmer_count.launches = kmer_count.global_launches = 0
    counts, ones = kmer_count(*packed, k, dtype_max)
    torch.cuda.synchronize()
    p_counts, p_ones = kmer_count_ref(*packed, k, dtype_max)
    assert counts.dtype == p_counts.dtype
    np.testing.assert_array_equal(counts.cpu().numpy(), p_counts.cpu().numpy())
    assert torch.equal(ones, p_ones)
    want_c, want_o = native.count_kmers_batch(recs, k, dtype_max)
    np.testing.assert_array_equal(counts.cpu().numpy(), want_c)
    np.testing.assert_array_equal(ones.cpu().numpy().astype(np.uint64), want_o)
    assert (kmer_count.launches, kmer_count.global_launches) == (1, int(k >= 8))
    if name == "saturation":
        assert int(counts.max()) == 255


@pytest.mark.cuda
def test_cuda_device_build_counts_defaults_to_the_card(monkeypatch):
    """device=None builds on the card, in chunks when they are small, and
    equals the native counter."""
    cuda_device()
    from meshclust2_tpu_torch.parallel import mesh

    recs = med2000(120)
    kmer_count.launches = 0
    monkeypatch.setitem(mesh.CHUNK_CODES, "cuda", 50_000)
    counts, ones = device_build_counts(recs, 5, 255)
    want_c, want_o = native.count_kmers_batch(recs, 5, 255)
    np.testing.assert_array_equal(counts, want_c)
    np.testing.assert_array_equal(ones, want_o)
    assert kmer_count.launches > 1
