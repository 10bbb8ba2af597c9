"""Mean-shift clustering of DNA sequences with pair scoring on an NVIDIA card.

    python -m meshclust2_tpu_torch.cli --device cuda --id 0.9 in.fasta
    python -m meshclust2_tpu_torch.cli --device cuda --recover W.txt \\
        --output out.clstr in.fasta

Mirrors meshclust2_tpu/cli.py:_main_impl (lines 361-509): FASTA reading,
k-mer counting and sorting, then either the weights of a training run
(`--recover`) or training at runtime, then clustering and the CLSTR writer.
Training builds its pair tables on the card (train/device_tables.py: the
pair-statistics kernel and the float64 epilogue), as the JAX package does
under --device tpu; `--dump` writes the weights and stops.

A TorchDeviceSession holds the one store upload: its accumulator runs the
accumulate phase as a step loop on the card (the pair-statistics,
window-absorb and closest-to-mean kernels), and its updater runs each
update iteration's filter and closest-to-mean, and each merge pass, as one
batch on the card.  The JAX package's switches select the older paths:
MC2_NO_DEVICE_LOOP runs the accumulate windows through the scorer and the
engine's host loop, and MC2_NO_DEVICE_UPDATE_BATCH the update phase through
the scorer and the engine's native host argmin.

The engine falls back to its host paths, printing a line, when the device
accumulate loop raises.  Here the error is raised again after the run, so
the exit code shows it; guarded aborts are not errors and resolve on the
host by design.  Models with singles the pair statistics cannot derive
(`--feat slow`, `--feat extraslow`) exit non-zero: the port has no device
path for them and no quiet host fallback.

Clock stamps follow the JAX package: on the recover path the store upload,
the kernel builds and one warm-up call of each batch happen before the
`read_in_points` stamp, so the window from it to `done` holds clustering
only (BASELINE.md methodology); a training run stamps `data_generation` and
`GLM` inside that window and builds its session after training.
"""
from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .cluster.device_loop import DeviceLoopUnsupported, TorchDeviceAccumulator
from .cluster.device_session import TorchDeviceSession
from .cluster.device_update import TorchDeviceUpdater
from .cluster.engine import MeanShiftEngine
from .features import flags as F
from .io.clstr import write_clstr
from .io.fasta import read_fasta
from .kmer.counting import (PointSet, build_point_set, concat_point_sets,
                            find_k, largest_pseudocount, select_datatype)
from .model.classifier import CompiledModel
from .model.weights import PredictorModel, load_weights, save_weights
from .ops.device_features import TorchDeviceScorer, check_fused
from .runtime import resolve_device
from .train.device_tables import TableStats
from .utils.clock import Clock
from .utils.progress import Progress

MUT_SINGLE = 1
MUT_NON_SINGLE = 2
MUT_BOTH = MUT_SINGLE | MUT_NON_SINGLE
MUT_TRANSLOCATION = 4
MUT_REVERSION = 8
MUT_ATYPICAL = MUT_TRANSLOCATION | MUT_REVERSION

MUT_TYPES = {
    "all": MUT_BOTH | MUT_ATYPICAL,
    "both": MUT_BOTH,
    "snp": MUT_SINGLE,
    "single": MUT_SINGLE,
    "nonsingle-typical": MUT_NON_SINGLE,
    "nonsingle-all": MUT_NON_SINGLE | MUT_ATYPICAL,
    "all-but-reversion": MUT_BOTH | MUT_TRANSLOCATION,
    "all-but-translocation": MUT_BOTH | MUT_REVERSION,
}

FEAT_SETS = {
    "fast": F.PRED_FEAT_FAST,
    "slow": F.PRED_FEAT_FAST | F.PRED_FEAT_DIV,
    "extraslow": F.PRED_FEAT_ALL,
}

DATATYPES = {
    "8": "uint8_t", "uint8": "uint8_t", "uint8_t": "uint8_t",
    "16": "uint16_t", "uint16": "uint16_t", "uint16_t": "uint16_t",
    "32": "uint32_t", "uint32": "uint32_t", "uint32_t": "uint32_t",
    "64": "uint64_t", "uint64": "uint64_t", "uint64_t": "uint64_t",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="meshclust2-torch",
        description="mean-shift clustering of DNA sequences with pair "
                    "scoring on an NVIDIA GPU",
    )
    p.add_argument("files", nargs="*", help="FASTA input files")
    p.add_argument("--id", type=float, default=0.90, dest="identity")
    p.add_argument("-k", "--kmer", type=int, default=-1)
    p.add_argument("--dump", nargs="?", const="weights.txt", default=None,
                   help="write the trained weights to this file and stop")
    p.add_argument("-r", "--recover", default=None,
                   help="weights file from a training run (skips training)")
    p.add_argument("--mut-type", choices=sorted(MUT_TYPES), default="both")
    p.add_argument("--feat", "-f", choices=sorted(FEAT_SETS), default="fast")
    p.add_argument("--single-file", action="store_true")
    p.add_argument("-s", "--sample", type=int, default=2000)
    p.add_argument("--num-templates", type=int, default=300)
    p.add_argument("--min", "--min-feat", dest="min_feat", type=int, default=4)
    p.add_argument("--max", "--max-feat", dest="max_feat", type=int, default=4)
    p.add_argument("--min-id", type=float, default=0.35)
    p.add_argument("--datatype", choices=sorted(DATATYPES), default=None)
    p.add_argument("-o", "--output", default="output.clstr")
    p.add_argument("-d", "--delta", type=int, default=5)
    p.add_argument("-i", "--iter", "--iterations", dest="iterations",
                   type=int, default=15)
    p.add_argument("-b", "--bias", type=float, default=0.0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where pair tables and pair scoring run; cpu runs "
                        "the kernels' plain PyTorch versions")
    return p


def load_sorted_points(
    train_files: List[str],
    notrain_files: List[str],
    k: int,
    datatype: str,
    single_file: bool,
    keep_seqs_train: bool = True,
    records_cache: Optional[dict] = None,
) -> tuple:
    """get_points for train + notrain files with the reference's sort-by-
    header-then-length (CRunner.cpp:504-544) and id assignment in final
    length order (CRunner.cpp:577-593).

    Returns (train_ps_sorted, all_ps_sorted)."""
    n_files = len(train_files) + len(notrain_files)
    prog = Progress(n_files, f"Counting {k}-mers")  # CRunner.cpp:517-519

    def load(files, keep):
        sets = []
        for fpath in files:
            if records_cache is not None and fpath in records_cache:
                recs = records_cache[fpath]
            else:
                recs = read_fasta(fpath, single_file)
            if recs:
                sets.append(build_point_set(recs, k, datatype, keep_seqs=keep))
            prog.step()
        return sets

    train_sets = load(train_files, keep_seqs_train)
    train_ps = concat_point_sets(train_sets) if train_sets else None
    if train_ps is not None:
        train_ps = sort_points(train_ps)
    notrain_sets = load(notrain_files, False)
    prog.end()
    if notrain_sets:
        rest = concat_point_sets(notrain_sets)
        combined = concat_point_sets([train_ps, rest]) if train_ps is not None else rest
        combined = sort_points(combined)
    else:
        combined = train_ps
    if combined is not None:
        combined.ids = np.arange(combined.n, dtype=np.int64)
    return train_ps, combined


def sort_points(ps: PointSet) -> PointSet:
    """Sort by header, then by length — two sequential std::sorts
    (CRunner.cpp:538-539).  Uses the native std::sort permutation helper so
    equal-length tie order matches the reference's unstable introsort."""
    from .native import sort_perm, sort_perm_strings

    p1 = sort_perm_strings(ps.headers)
    # compose the two permutations so the big column arrays are gathered
    # once: the second (unstable-introsort) key runs over the header-sorted
    # length order, exactly as the sequential std::sorts would
    p2 = sort_perm(np.asarray(ps.lengths)[p1])
    return ps.subset(p1[p2])


@dataclass
class ClusterRun:
    rc: int
    engine: Optional[MeanShiftEngine] = None
    scorer: Optional[TorchDeviceScorer] = None
    updater: Optional[TorchDeviceUpdater] = None
    accumulator: Optional[TorchDeviceAccumulator] = None
    clock: Optional[Clock] = None
    trained: Optional[PredictorModel] = None   # the model a training run made
    tables: Optional[TableStats] = None        # its pair tables' builder


def _session(ps: PointSet, model: CompiledModel, device, sim: float
             ) -> TorchDeviceSession:
    session = TorchDeviceSession(
        ps, model, device, sim,
        update_batch=not os.environ.get("MC2_NO_DEVICE_UPDATE_BATCH"),
        device_loop=not os.environ.get("MC2_NO_DEVICE_LOOP"))
    session.warm_up()
    return session


def run(argv: Optional[List[str]] = None) -> ClusterRun:
    """Everything `main` does, returning the engine (its counters), the
    scorer, the accumulator, the updater, the clock stamps and, for a
    training run, the trained model and its table counters beside the exit
    code."""
    args = build_parser().parse_args(argv)
    files = sorted(set(args.files))
    if not files:
        build_parser().print_help()
        return ClusterRun(rc=1)
    device = resolve_device(args.device)
    clock = Clock()
    try:
        return _run(args, files, device, clock)
    except DeviceLoopUnsupported as e:
        print(f"meshclust2-torch: {e}: the port computes only the singles "
              f"that derive from the pair statistics (--feat fast); models "
              f"with others cannot be trained or clustered by it yet",
              file=sys.stderr)
        return ClusterRun(rc=2, clock=clock)


def _run(args, files: List[str], device, clock: Clock) -> ClusterRun:
    if not args.recover:
        # the tables of every single of the feature set are built on the
        # card: fail before any work when one is not derivable
        check_fused(F.split_flags(FEAT_SETS[args.feat]))
    recovered: Optional[PredictorModel] = None
    k = args.kmer
    similarity = args.identity
    datatype = DATATYPES[args.datatype] if args.datatype else None
    if args.recover:
        recovered = load_weights(args.recover)
        k = recovered.k
        similarity = recovered.id_cutoff
        datatype = recovered.datatype

    records_cache = {}
    prog = Progress(len(files), "Reading in sequences")  # CRunner.cpp:58
    for f in files:
        records_cache[f] = read_fasta(f, args.single_file)
        prog.step()
    prog.end()
    per_file_records = [records_cache[f] for f in files]

    if k == -1:
        try:
            k = find_k(per_file_records, len(files))
        except ValueError:
            print("No sequences found in input; writing empty output",
                  file=sys.stderr)
            write_clstr(args.output, [])
            clock.stamp("done")
            return ClusterRun(rc=1, clock=clock)
        print(f"Recommended K: {k}")

    if datatype is None:
        largest = 0
        for recs in per_file_records:
            largest = max(largest, largest_pseudocount(recs, k))
        print(f"Largest count: {largest}")
        datatype = select_datatype(largest)
    bits = {"uint8_t": 8, "uint16_t": 16, "uint32_t": 32, "uint64_t": 64}[datatype]
    print(f"Using {bits} bit histograms")  # CRunner.cpp:109-121

    train_ps, all_ps = load_sorted_points(
        files, [], k, datatype, args.single_file,
        keep_seqs_train=recovered is None, records_cache=records_cache)
    records_cache.clear()

    session = None
    model: Optional[CompiledModel] = None
    if recovered is not None and all_ps is not None and all_ps.n:
        # the device bring-up before the read_in_points stamp (recover path)
        model = CompiledModel(recovered.classifier, bias=args.bias)
        session = _session(all_ps, model, device, similarity)
    clock.stamp("read_in_points")

    if all_ps is None or all_ps.n == 0:
        print("No sequences found in input; writing empty output",
              file=sys.stderr)
        write_clstr(args.output, [])
        clock.stamp("done")
        return ClusterRun(rc=1, clock=clock)

    trained = tables = None
    if recovered is None:
        from .train.predictor import train_predictor

        min_id = args.min_id
        if similarity < 0.6:
            min_id = 0.2  # CRunner.cpp:570-574
        print("Splitting data")  # Trainer.cpp:174
        tables = TableStats()
        trained = train_predictor(
            train_ps,
            k=k,
            identity=similarity,
            datatype=datatype,
            feat_flags=FEAT_SETS[args.feat],
            mut_type=MUT_TYPES[args.mut_type],
            min_feat=args.min_feat,
            max_feat=args.max_feat,
            min_id=min_id,
            n_samples=args.sample,
            n_templates=args.num_templates,
            clock=clock,
            device=device,
            table_stats=tables,
        )
        save_weights(args.dump or "weights.txt", trained)
        if args.dump:
            return ClusterRun(rc=0, clock=clock, trained=trained,
                              tables=tables)
        model = CompiledModel(trained.classifier, bias=args.bias)
        session = _session(all_ps, model, device, similarity)

    # clustering runs on all points, sequences dropped
    all_ps.seqs = None
    engine = MeanShiftEngine(all_ps, model, similarity,
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
                      updater=session.updater, accumulator=acc, clock=clock,
                      trained=trained, tables=tables)


def main(argv: Optional[List[str]] = None) -> int:
    return run(argv).rc


if __name__ == "__main__":
    sys.exit(main())
