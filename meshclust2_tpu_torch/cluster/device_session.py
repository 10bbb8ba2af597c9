"""The device state of one clustering run, as MeanShiftEngine reads it.

The counterpart of meshclust2_tpu/cluster/device_session.py:DeviceSession
(lines 378-441) without its whole-run program: one DeviceStore upload,
shared by the pair scorer, the accumulate loop (`accumulator`, a
TorchDeviceAccumulator over the pristine pool `bv`), the whole update
phase (`phase`, a TorchDevicePhaseUpdater) and the update-phase batches
(`updater`, whose decisions the phase makes too).  The engine (cluster/engine.py) runs its device accumulate
loop exactly when `accumulator` is set, its update phase on the card when
`phase` is, and its per-iteration update batches when `updater` is (after
a guarded abort of the phase too).  Without the device loop (the JAX
package's MC2_NO_DEVICE_LOOP configuration) the accumulate windows go
through the scorer, and there is no phase.  A model with plane singles,
which the device loops do not take (ops/device_features.py:loop_refusal;
the JAX session and DeviceUpdater refuse it too), gets the store, the
scorer's plane store and the scorer only: the engine runs both phases
through the scorer.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kmer.counting import PointSet
from ..model.classifier import CompiledModel
from ..ops.device_features import TorchDeviceScorer, loop_refusal
from .bvec import BVec
from .device_loop import TorchDeviceAccumulator
from .device_phase import TorchDevicePhaseUpdater
from .device_store import DeviceStore
from .device_update import TorchDeviceUpdater


# MeanShiftEngine's default bin_size, the one the port's CLI runs with
BIN_SIZE = 1000


class TorchDeviceSession:
    """Store, scorer, accumulator and updater for one run, built before the
    clustering window opens."""

    def __init__(self, ps: PointSet, model: CompiledModel, device, sim: float,
                 update_batch: bool = True, device_loop: bool = True,
                 delta: int = 5, iterations: int = 15):
        """update_batch=False leaves `updater` and `phase` None: the engine
        then runs the update phase through the scorer (the JAX package's
        MC2_NO_DEVICE_UPDATE_BATCH configuration).  device_loop=False
        leaves `accumulator` and `phase` None (MC2_NO_DEVICE_LOOP).  All
        are None for a model that the device loops do not take.  delta and
        iterations are the engine's, for the phase."""
        self.store = DeviceStore.from_pointset(ps, torch.device(device))
        self.scorer = TorchDeviceScorer(ps, model, device, store=self.store)
        loops = loop_refusal(model.singles) is None
        self.updater: Optional[TorchDeviceUpdater] = (
            TorchDeviceUpdater(model, self.store)
            if update_batch and loops else None)
        self.bv: Optional[BVec] = None
        self.accumulator: Optional[TorchDeviceAccumulator] = None
        self.phase: Optional[TorchDevicePhaseUpdater] = (
            TorchDevicePhaseUpdater(ps, model, sim, self.store, delta=delta,
                                    iterations=iterations, updater=self.updater)
            if device_loop and self.updater is not None else None)
        if device_loop and loops:
            # the pristine pool, as the engine builds it (engine.py:1148)
            self.bv = BVec(ps.lengths, BIN_SIZE)
            self.bv.insert_all(ps.lengths)
            self.bv.insert_finalize(ps.lengths)
            self.accumulator = TorchDeviceAccumulator(ps, model, sim,
                                                      self.store)

    def warm_up(self) -> None:
        """Build the kernels, run each batch once, and upload the
        accumulate loop's and the phase's per-row arrays."""
        self.scorer.warm_up()
        if self.updater is not None:
            self.updater.warm_up()
        if self.phase is not None:
            self.phase.warm_up()
        if self.accumulator is not None:
            self.accumulator.ensure_ready(self.bv)
