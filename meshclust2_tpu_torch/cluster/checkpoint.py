"""Clustering-phase checkpoint/resume.

The reference's only persistence seam is the trained classifier
(`--dump`/`--recover`, Trainer.cpp:185-189); a crash mid-clustering loses
everything (SURVEY §5: "No clustering-phase checkpointing exists").  This
module adds what production runs over 100k+ sequence pools need: the
cluster state after the expensive accumulate phase (and after each update
iteration) is a compact set of integer arrays, saved atomically and
restored exactly — including the update loop's iteration counter and
cluster-count history, so a resumed run takes the identical early-stop
path and produces a byte-identical CLSTR.
"""
from __future__ import annotations

import hashlib
import os
from typing import List, Optional, Tuple

import numpy as np


def dataset_fingerprint(ps, params: Optional[tuple] = None) -> str:
    """Cheap stable fingerprint of the point set (and, when given, the
    clustering parameters) a checkpoint belongs to.  Including the
    parameters refuses resumes under a different --id/--delta/--iterations/
    bin size, which would silently mix two configurations."""
    h = hashlib.sha256()
    h.update(np.int64(ps.n).tobytes())
    h.update(np.int64(ps.k).tobytes())
    h.update(np.ascontiguousarray(ps.lengths, dtype=np.int64).tobytes())
    h.update(np.ascontiguousarray(ps.ids, dtype=np.int64).tobytes())
    if params is not None:
        h.update(repr(params).encode())
    return h.hexdigest()[:32]


def save_checkpoint(path: str, clusters, *, phase: str, iteration: int,
                    num_clusters: List[int], fingerprint: str) -> None:
    """Atomic npz snapshot of the live (non-deleted) clusters."""
    live = [c for c in clusters if not c.deleted]
    centers = np.array([c.center_row for c in live], dtype=np.int64)
    offsets = np.zeros(len(live) + 1, dtype=np.int64)
    np.cumsum([len(c.members) for c in live], out=offsets[1:])
    members = (
        np.concatenate([np.asarray(c.members, dtype=np.int64) for c in live])
        if live else np.zeros(0, dtype=np.int64)
    )
    save_checkpoint_arrays(path, centers, offsets, members, phase=phase,
                           iteration=iteration, num_clusters=num_clusters,
                           fingerprint=fingerprint)


def save_checkpoint_arrays(path: str, centers, offsets, members, *,
                           phase: str, iteration: int,
                           num_clusters: List[int], fingerprint: str) -> None:
    """save_checkpoint over already-flattened (centers, offsets, members)
    int64 arrays — the native update driver's per-iteration export format."""
    tmp = path + ".tmp"
    np.savez_compressed(
        tmp if tmp.endswith(".npz") else tmp,
        centers=centers,
        offsets=offsets,
        members=members,
        phase=np.bytes_(phase.encode()),
        iteration=np.int64(iteration),
        num_clusters=np.asarray(num_clusters, dtype=np.int64),
        fingerprint=np.bytes_(fingerprint.encode()),
    )
    # np.savez appends .npz to names without it
    actual_tmp = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(actual_tmp, path)


def load_checkpoint(path: str, fingerprint: str) -> Tuple[list, dict]:
    """Restore (clusters, meta).  Raises ValueError when the checkpoint was
    written for a different dataset."""
    from .engine import Cluster

    with np.load(path) as z:
        saved_fp = bytes(z["fingerprint"]).decode()
        if saved_fp != fingerprint:
            raise ValueError(
                "checkpoint was written for a different dataset or "
                "clustering parameters "
                f"(fingerprint {saved_fp} != {fingerprint})"
            )
        centers = z["centers"]
        offsets = z["offsets"]
        members = z["members"]
        meta = {
            "phase": bytes(z["phase"]).decode(),
            "iteration": int(z["iteration"]),
            "num_clusters": [int(v) for v in z["num_clusters"]],
        }
    clusters = [
        Cluster(
            center_row=int(centers[i]),
            members=[int(m) for m in members[offsets[i] : offsets[i + 1]]],
        )
        for i in range(len(centers))
    ]
    return clusters, meta
