"""The pool generator: deterministic, and seed 424242's 10k pool 0 is the
repository's historical bench set byte for byte."""
import hashlib

from harness.pools import _historical_sizes, pool_bytes, pool_rng, wrap

import numpy as np

# sha256 of bench.py:ensure_dataset's file (10,000 sequences, seed 424242)
BENCH10K_SHA256 = "8cf7c5fc4cb68d56ee95732e8d25b8cb73e9cbc81a74d12d28243163efdf1b1f"
MIX = dict(n_templates=200, len_lo=800, len_hi=1500, rate_lo=0.01, rate_hi=0.12)


def test_seed_424242_pool_0_is_the_bench_set():
    data = pool_bytes(424242, 0, 10000, **MIX)
    assert hashlib.sha256(data).hexdigest() == BENCH10K_SHA256


def test_same_seed_same_pool_and_pools_differ():
    a = pool_bytes(2**31 + 5, 1, 400, **dict(MIX, n_templates=20))
    b = pool_bytes(2**31 + 5, 1, 400, **dict(MIX, n_templates=20))
    c = pool_bytes(2**31 + 5, 2, 400, **dict(MIX, n_templates=20))
    d = pool_bytes(2**31 + 6, 1, 400, **dict(MIX, n_templates=20))
    assert a == b
    assert a != c and a != d
    assert a.count(b">") == 400


def test_wrap_lines():
    seq = np.frombuffer(b"ACGT" * 36, dtype=np.uint8)   # 144 bases
    text = wrap(seq, 70).tobytes()
    assert text == b"ACGT" * 17 + b"AC\n" + b"GT" + b"ACGT" * 17 + b"\n" + b"ACGT\n"


def test_historical_sizes_skip_the_bases_exactly():
    # the lengths and rates read by skipping are those the full draws give
    for pool in (0, 1, 3):
        rng = pool_rng(424242, pool)
        lengths, rates = [], []
        for _ in range(7):
            tl = int(rng.integers(800, 1500))
            rng.integers(0, 4, tl)
            lengths.append(tl)
            row = []
            for _ in range(5):
                row.append(rng.uniform(0.01, 0.12))
                rng.random(tl)
                rng.integers(0, 4, tl)
            rates.append(row)
        assert _historical_sizes(pool, 7, 5, 800, 1500, 0.01, 0.12) == (lengths, rates)


def test_every_seed_gets_the_same_sizes():
    def lengths(seed):
        text = pool_bytes(seed, 1, 200, **dict(MIX, n_templates=10))
        return [len(r.split(b"\n", 1)[1].replace(b"\n", b"")) for r in text.split(b">")[1:]]
    a, b = lengths(17), lengths(2**31 + 17)
    # a record's length is its template's less the deletions, ~0.3 r of it
    assert max(abs(x - y) for x, y in zip(a, b)) < 0.05 * 1500
