"""Device-resident per-point arrays for the port.

The counterpart of meshclust2_tpu/cluster/device_session.py:DeviceStore
(lines 42-86), without `force()`, the touch program or `from_global`: one
upload of the natural-order uint8/uint16 counts and the float64 per-row
moments that `derive_singles` reads, shared by the scorer, the accumulator
and the updater (cluster/device_session.py), and by the training tables
(train/device_tables.py).  Outside the exact-integer envelope
(`device_loop.envelope_check`), or for uint32/uint64 histograms, the store
raises `DeviceLoopUnsupported`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kmer.counting import PointSet


@dataclass(frozen=True)
class DeviceStore:
    counts: torch.Tensor      # [N, D] uint8/uint16, natural row order
    mags: torch.Tensor        # float64 [N] pseudo-magnitudes (exact integers)
    selfdot: torch.Tensor     # float64 [N] sum_i counts_i^2 (exact integers)
    lens: torch.Tensor        # float64 [N] effective lengths
    stddevs: torch.Tensor     # float64 [N]
    maxc: int                 # the largest count (closest-to-mean guards)

    @classmethod
    def from_pointset(cls, ps: PointSet, device) -> "DeviceStore":
        # imported here: device_loop imports this module through the scorer
        from .device_loop import DeviceLoopUnsupported, envelope_check

        if ps.counts.dtype not in (np.uint8, np.uint16):
            raise DeviceLoopUnsupported(
                f"{ps.counts.dtype} histograms (the kernel reads uint8/uint16)")
        self_dots = envelope_check(ps)

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return cls(
            counts=up(ps.counts),
            mags=up(ps.mags.astype(np.float64)),
            selfdot=up(self_dots.astype(np.float64)),
            lens=up(ps.lengths.astype(np.float64)),
            stddevs=up(ps.stddevs.astype(np.float64)),
            maxc=int(ps.counts.max()) if ps.n else 0,
        )
