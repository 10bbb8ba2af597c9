"""Recover-path clustering with pair scoring on an NVIDIA card.

    python -m meshclust2_tpu_torch.cli --device cuda --recover W.txt \\
        --output out.clstr in.fasta

Mirrors the recover branch of meshclust2_tpu/cli.py:_main_impl (lines
361-509) with the JAX package's own host code: FASTA reading, k-mer
counting and sorting, the weights file, CompiledModel, MeanShiftEngine and
the CLSTR writer.  A TorchDeviceSession holds the one store upload: its
accumulator runs the accumulate phase as a step loop on the card (the
pair-statistics, window-absorb and closest-to-mean kernels), and its
updater runs each update iteration's filter and closest-to-mean, and each
merge pass, as one batch on the card.  The JAX package's switches select
the older paths, as in its engine: MC2_NO_DEVICE_LOOP (engine.py:359) runs
the accumulate windows through the scorer and the engine's host loop, and
MC2_NO_DEVICE_UPDATE_BATCH (engine.py:684) the update phase through the
scorer and the engine's native host argmin.

The engine falls back to its host paths, printing a line, when the device
accumulate loop raises (engine.py:399-406, 458-472).  Here the error is
raised again after the run, so the exit code shows it; guarded aborts are
not errors and resolve on the host by design.

The store upload, the kernel builds and one warm-up call of each batch
happen before the `read_in_points` stamp, so the window from it to `done`
holds clustering only (BASELINE.md methodology); the engine stamps
`accumulate` between the two phases.  Training is not ported: without
--recover the command exits non-zero.
"""
from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass
from typing import List, Optional

from meshclust2_tpu.cli import load_sorted_points
from meshclust2_tpu.cluster.engine import MeanShiftEngine
from meshclust2_tpu.io.clstr import write_clstr
from meshclust2_tpu.model.classifier import CompiledModel
from meshclust2_tpu.model.weights import load_weights
from meshclust2_tpu.utils.clock import Clock

from .cluster.device_loop import TorchDeviceAccumulator
from .cluster.device_session import TorchDeviceSession
from .cluster.device_update import TorchDeviceUpdater
from .ops.device_features import TorchDeviceScorer
from .runtime import resolve_device


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="meshclust2-torch",
        description="mean-shift clustering of DNA sequences with pair "
                    "scoring on an NVIDIA GPU (recover path)",
    )
    p.add_argument("files", nargs="*", help="FASTA input files")
    p.add_argument("-r", "--recover", default=None,
                   help="weights file from a training run (required)")
    p.add_argument("-o", "--output", default="output.clstr")
    p.add_argument("-d", "--delta", type=int, default=5)
    p.add_argument("-i", "--iter", "--iterations", dest="iterations",
                   type=int, default=15)
    p.add_argument("-b", "--bias", type=float, default=0.0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where pair scoring runs; cpu runs the kernels' "
                        "plain PyTorch versions")
    return p


@dataclass
class ClusterRun:
    rc: int
    engine: Optional[MeanShiftEngine] = None
    scorer: Optional[TorchDeviceScorer] = None
    updater: Optional[TorchDeviceUpdater] = None
    accumulator: Optional[TorchDeviceAccumulator] = None
    clock: Optional[Clock] = None


def run(argv: Optional[List[str]] = None) -> ClusterRun:
    """Everything `main` does, returning the engine (its counters), the
    scorer, the accumulator, the updater and the clock stamps beside the
    exit code."""
    args = build_parser().parse_args(argv)
    if not args.recover:
        print("meshclust2-torch: --recover WEIGHTS is required; training on "
              "the card is not ported yet (train with python -m "
              "meshclust2_tpu.cli --dump)", file=sys.stderr)
        return ClusterRun(rc=2)
    files = sorted(set(args.files))
    if not files:
        build_parser().print_help()
        return ClusterRun(rc=1)
    device = resolve_device(args.device)
    clock = Clock()
    recovered = load_weights(args.recover)
    _, ps = load_sorted_points(files, [], recovered.k, recovered.datatype,
                               single_file=False, keep_seqs_train=False)
    if ps is None or ps.n == 0:
        print("No sequences found in input; writing empty output",
              file=sys.stderr)
        write_clstr(args.output, [])
        clock.stamp("done")
        return ClusterRun(rc=1, clock=clock)
    print(f"Using {ps.counts.dtype.itemsize * 8} bit histograms")
    model = CompiledModel(recovered.classifier, bias=args.bias)
    session = TorchDeviceSession(
        ps, model, device, recovered.id_cutoff,
        update_batch=not os.environ.get("MC2_NO_DEVICE_UPDATE_BATCH"),
        device_loop=not os.environ.get("MC2_NO_DEVICE_LOOP"))
    session.warm_up()
    clock.stamp("read_in_points")

    ps.seqs = None
    engine = MeanShiftEngine(ps, model, recovered.id_cutoff,
                             scorer=session.scorer, delta=args.delta,
                             iterations=args.iterations,
                             device_session=session)
    clusters = engine.run(clock=clock)
    acc = session.accumulator
    if acc is not None and acc.error is not None:
        raise RuntimeError("the device accumulate loop failed; the engine "
                           "finished on the host") from acc.error
    write_clstr(args.output, engine.to_output(clusters))
    clock.stamp("update")
    clock.stamp("done")
    return ClusterRun(rc=0, engine=engine, scorer=session.scorer,
                      updater=session.updater, accumulator=acc, clock=clock)


def main(argv: Optional[List[str]] = None) -> int:
    return run(argv).rc


if __name__ == "__main__":
    sys.exit(main())
