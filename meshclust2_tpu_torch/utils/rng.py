"""Deterministic RNG chain matching the reference's generators.

- LCG: the MMIX linear congruential generator, bit-exact (LCG.h:42-47).
- MinStd0: minstd_rand0 (x = 16807x mod 2^31-1), used for SingMute's command
  shuffle (SingMute.cpp:101) and the insertions shuffle seeded with 0
  (MultiMute.cpp:338-340, libstdc++ default_random_engine).
- MT: mt19937-backed Random equivalent (Random.h:12-60); distribution mapping
  is implementation-defined in C++, so parity here is statistical, not
  bitwise (SURVEY §4.3: exact parity is anchored on --recover).
"""
from __future__ import annotations

import random as _pyrandom

U64 = (1 << 64) - 1
U32 = (1 << 32) - 1


class LCG:
    __slots__ = ("seed",)

    def __init__(self, seed: int):
        self.seed = seed & U64

    def random(self) -> int:
        self.seed = (self.seed * 6364136223846793005 + 1442695040888963407) & U64
        return self.seed

    def rand_mod(self, max_val: int) -> int:
        if max_val == 0:
            return 0
        return self.random() % max_val

    def next_rand_seed(self) -> int:
        return self.random()

    def rand_between(self, id_: float, rng: float, low: float, high: float) -> float:
        res = self.random() / U64
        mn = max(id_ - rng, low)
        mx = min(id_ + rng, high)
        return mn + (mx - mn) * res


class MinStd0:
    """linear_congruential_engine<uint, 16807, 0, 2147483647> (minstd_rand0)."""

    __slots__ = ("x",)
    M = 2147483647

    def __init__(self, seed: int):
        s = seed % self.M
        self.x = 1 if s == 0 else s

    def __call__(self) -> int:
        self.x = (self.x * 16807) % self.M
        return self.x


def uniform_int(gen, gen_min: int, gen_max: int, b: int) -> int:
    """libstdc++ uniform_int_distribution(0, b) on generator `gen`
    (bits/uniform_int_dist.h).  Full-32-bit generators (mt19937) use
    Lemire's nearly-divisionless downscale (product >> 32 with low-word
    rejection); others fall back to the 2-division scale-and-reject."""
    urngrange = gen_max - gen_min
    uerange = b + 1
    if urngrange == U32:
        rng = uerange
        product = gen() * rng
        low = product & U32
        if low < rng:
            threshold = (U32 + 1 - rng) % rng
            while low < threshold:
                product = gen() * rng
                low = product & U32
        return product >> 32
    scaling = urngrange // uerange
    past = uerange * scaling
    while True:
        r = gen() - gen_min
        if r < past:
            return r // scaling


def shuffle_libstdcxx(seq: list, gen, gen_min: int = 1,
                      gen_max: int = 2147483646) -> None:
    """libstdc++ std::shuffle (bits/stl_algo.h): when the generator range is
    at least n^2, one draw yields two swap indices per pair of iterations
    (__gen_two_uniform_ints); otherwise classic per-iteration draws.
    Defaults are the minstd_rand0 engine bounds."""
    n = len(seq)
    if n <= 1:
        return
    urngrange = gen_max - gen_min

    def uid(b):
        return uniform_int(gen, gen_min, gen_max, b)

    if urngrange // n >= n:
        i = 1
        if n % 2 == 0:
            j = uid(1)
            seq[i], seq[j] = seq[j], seq[i]
            i += 1
        while i < n:
            swap_range = i + 1
            x = uid(swap_range * (swap_range + 1) - 1)
            p0, p1 = x // (swap_range + 1), x % (swap_range + 1)
            seq[i], seq[p0] = seq[p0], seq[i]
            i += 1
            if i == n:
                break
            seq[i], seq[p1] = seq[p1], seq[i]
            i += 1
        return
    for i in range(1, n):
        j = uid(i)
        seq[i], seq[j] = seq[j], seq[i]


class MTRandom:
    """Bit-exact equivalent of the reference's Random wrapper
    (Random.h:12-60): std::mt19937 seeded with a single value (numpy's
    legacy MT19937 seeding matches C++ exactly) and libstdc++
    uniform_int_distribution mapping."""

    MT_MIN = 0
    MT_MAX = U32

    def __init__(self, seed: int = 0xAA):
        import numpy as _np

        bg = _np.random.MT19937()
        bg._legacy_seeding(seed)
        self._bg = bg

    def _raw(self) -> int:
        return int(self._bg.random_raw(1)[0])

    def rand_mod(self, max_val: int) -> int:
        if max_val == 0:
            return 0
        return uniform_int(self._raw, self.MT_MIN, self.MT_MAX, max_val - 1)

    def next_rand_seed(self) -> int:
        # randMod<uint32>(uint32_max) -> distribution(0, 2^32-2): scaling=1,
        # reject only 0xFFFFFFFF -> raw mt19937 outputs
        return self.rand_mod(U32)

    def random(self) -> float:
        # uniform_real_distribution(0,1): generate_canonical<double, 53>
        # draws two 32-bit values (low then high) in libstdc++
        a = self._raw()
        b = self._raw()
        return ((b * float(2**32)) + a) / float(2**64)

    def shuffle(self, seq: list) -> None:
        shuffle_libstdcxx(seq, self._raw, self.MT_MIN, self.MT_MAX)
