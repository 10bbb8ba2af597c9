"""The device state of one clustering run, as MeanShiftEngine reads it.

The counterpart of meshclust2_tpu/cluster/device_session.py:DeviceSession
(lines 378-441) without its whole-run program: one DeviceStore upload,
shared by the pair scorer, the accumulate loop (`accumulator`, a
TorchDeviceAccumulator over the pristine pool `bv`) and the update-phase
batches (`updater`).  The engine (cluster/engine.py) runs its device
accumulate loop exactly when `accumulator` is set and its update batches
when `updater` is.  Without the device loop (the JAX package's
MC2_NO_DEVICE_LOOP configuration) the accumulate windows go through the
scorer.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kmer.counting import PointSet
from ..model.classifier import CompiledModel
from ..ops.device_features import TorchDeviceScorer
from .bvec import BVec
from .device_loop import TorchDeviceAccumulator
from .device_store import DeviceStore
from .device_update import TorchDeviceUpdater


# MeanShiftEngine's default bin_size, the one the port's CLI runs with
BIN_SIZE = 1000


class TorchDeviceSession:
    """Store, scorer, accumulator and updater for one run, built before the
    clustering window opens."""

    def __init__(self, ps: PointSet, model: CompiledModel, device, sim: float,
                 update_batch: bool = True, device_loop: bool = True):
        """update_batch=False leaves `updater` None: the engine then runs
        the update phase through the scorer (the JAX package's
        MC2_NO_DEVICE_UPDATE_BATCH configuration).  device_loop=False
        leaves `accumulator` None (MC2_NO_DEVICE_LOOP)."""
        self.store = DeviceStore.from_pointset(ps, torch.device(device))
        self.scorer = TorchDeviceScorer(ps, model, device, store=self.store)
        self.updater: Optional[TorchDeviceUpdater] = (
            TorchDeviceUpdater(model, self.store)
            if update_batch else None)
        self.bv: Optional[BVec] = None
        self.accumulator: Optional[TorchDeviceAccumulator] = None
        if device_loop:
            # the pristine pool, as the engine builds it (engine.py:1148)
            self.bv = BVec(ps.lengths, BIN_SIZE)
            self.bv.insert_all(ps.lengths)
            self.bv.insert_finalize(ps.lengths)
            self.accumulator = TorchDeviceAccumulator(ps, model, sim,
                                                      self.store)

    def warm_up(self) -> None:
        """Build the kernels, run each batch once, and upload the
        accumulate loop's per-row arrays."""
        self.scorer.warm_up()
        if self.updater is not None:
            self.updater.warm_up()
        if self.accumulator is not None:
            self.accumulator.ensure_ready(self.bv)
