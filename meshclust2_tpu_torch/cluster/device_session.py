"""The device state of one clustering run, as MeanShiftEngine reads it.

The counterpart of meshclust2_tpu/cluster/device_session.py:DeviceSession
(lines 378-441) in its per-iteration-updater configuration: one DeviceStore
upload, shared by the pair scorer and the update-phase batches.  The
engine reads `updater` (engine.py:676-677) and skips the whole-phase
program and the device accumulate loop, which are not ported: `phase`,
`combined` and `accumulator` are None, and the scorer keeps
`prefers_device_loop = False` (engine.py:362-366, 947-949).
"""
from __future__ import annotations

from typing import Optional

import torch

from meshclust2_tpu.kmer.counting import PointSet
from meshclust2_tpu.model.classifier import CompiledModel

from ..ops.device_features import TorchDeviceScorer
from .device_store import DeviceStore
from .device_update import TorchDeviceUpdater


class TorchDeviceSession:
    """Store, scorer and updater for one run, built before the clustering
    window opens."""

    phase = None
    combined = None
    accumulator = None

    def __init__(self, ps: PointSet, model: CompiledModel, device,
                 update_batch: bool = True):
        """update_batch=False leaves `updater` None: the engine then runs
        the update phase through the scorer (the JAX package's
        MC2_NO_DEVICE_UPDATE_BATCH configuration)."""
        self.store = DeviceStore.from_pointset(ps, torch.device(device))
        self.scorer = TorchDeviceScorer(ps, model, device, store=self.store)
        self.updater: Optional[TorchDeviceUpdater] = (
            TorchDeviceUpdater(model, self.store)
            if update_batch else None)

    def warm_up(self) -> None:
        """Build the kernels and run each batch once."""
        self.scorer.warm_up()
        if self.updater is not None:
            self.updater.warm_up()
