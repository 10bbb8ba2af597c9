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

The device paths take the singles the pair statistics derive and the
full-vector ones (the log divergences and the blockwise singles of `--feat
slow` and `extraslow`: the fused kernel's FULL instantiation).  A model
with plane singles (markov, sim_mm, rre_k_r, spearman, d2s, d2*, afd,
n2r*), which the device loops do not take (`device_features.loop_refusal`,
as the JAX package's device session refuses them), gets a session with the
scorer alone: every batch of the engine's host-driven accumulate windows,
update filter and merge goes through TorchDeviceScorer (the plane-singles
kernel, then the fused kernel's PLANE instantiation), as the JAX CLI's
`--device tpu` sends them to its DeviceScorer, with one stderr line.  A
model with a single that has no device formula at all
(`device_features.scorer_refusal`) and a pool that the kernels do not take
(uint32/uint64 histograms, or counts outside the exact-integer envelope,
`device_store.store_refusal`) get no session: they are clustered by the
engine copy on the port's native host scorer, as the JAX CLI's `--device
host` clusters them, with one stderr line naming the reason.  Training tables come from the host oracle for such a pool, and
for a feature set with singles the statistics do not derive
(train/device_tables.py:stats_refusal), as in the JAX package.  This is
routing by input, decided before any device work; a kernel that fails on
input it takes still raises.

The engine falls back to its host paths, printing a line, when the device
accumulate loop raises.  Here the error is raised again after the run, so
the exit code shows it; guarded aborts are not errors and resolve on the
host by design.

`-l/--list`, `--no-train-list`, `-t/--threads` (the native host
library's threads), `--checkpoint` and `--resume-cluster` are the JAX
CLI's (meshclust2_tpu/cli.py:340-373, 504-505).  `--profile [DIR]` is its
flag too (cli.py:119-126, 347-358), through torch.profiler: the context
wraps the whole run and writes a Chrome trace into DIR when it closes.

Clock stamps follow the JAX package: on the recover path the store upload,
the kernel builds and one warm-up call of each batch happen before the
`read_in_points` stamp, so the window from it to `done` holds clustering
only (BASELINE.md methodology); a training run stamps `data_generation` and
`GLM` inside that window and builds its session after training.  The run's
clock (utils/clock.py) is the current one while it runs: its spans time
set-up (`setup.read`, `setup.count` with the rows' moments `setup.moments`,
`setup.session` with `session.upload` and `session.warm`, and each check of
the store's integer envelope `session.envelope`), the engine's layers
below, and the CLSTR write (`update.write`); under `--profile` each span is
also a range of the trace.
"""
from __future__ import annotations

import argparse
import os
import sys
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from .cluster.device_loop import TorchDeviceAccumulator
from .cluster.device_phase import TorchDevicePhaseUpdater
from .cluster.device_session import TorchDeviceSession
from .cluster.device_store import store_refusal
from .cluster.device_update import TorchDeviceUpdater
from .cluster.engine import HostScorer, MeanShiftEngine, Scorer
from .features import flags as F
from .io.clstr import write_clstr
from .io.fasta import read_fasta
from .kmer.counting import (PointSet, build_point_set, concat_point_sets,
                            find_k, largest_pseudocount, select_datatype)
from .model.classifier import CompiledModel
from .model.weights import PredictorModel, load_weights, save_weights
from .ops.device_features import loop_refusal, scorer_refusal
from .runtime import resolve_device
from .train.device_tables import TableStats
from .utils.clock import Clock, span
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
    p.add_argument("-l", "--list", dest="list_file", default=None,
                   help="file listing more FASTA files, one a line")
    p.add_argument("--no-train-list", "--notrain-list", dest="notrain_list",
                   default=None,
                   help="file listing FASTA files that are clustered but "
                        "not trained on")
    p.add_argument("--mut-type", choices=sorted(MUT_TYPES), default="both")
    p.add_argument("--feat", "-f", choices=sorted(FEAT_SETS), default="fast")
    p.add_argument("--single-file", action="store_true")
    p.add_argument("-s", "--sample", type=int, default=2000)
    p.add_argument("--num-templates", type=int, default=300)
    p.add_argument("--min", "--min-feat", dest="min_feat", type=int, default=4)
    p.add_argument("--max", "--max-feat", dest="max_feat", type=int, default=4)
    p.add_argument("--min-id", type=float, default=0.35)
    p.add_argument("--datatype", choices=sorted(DATATYPES), default=None)
    p.add_argument("-t", "--threads", type=int, default=0,
                   help="cap the native host library's threads")
    p.add_argument("-o", "--output", default="output.clstr")
    p.add_argument("-d", "--delta", type=int, default=5)
    p.add_argument("-i", "--iter", "--iterations", dest="iterations",
                   type=int, default=15)
    p.add_argument("-b", "--bias", type=float, default=0.0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where pair tables and pair scoring run; cpu runs "
                        "the kernels' plain PyTorch versions")
    p.add_argument("--checkpoint", default=None, metavar="FILE",
                   help="write a clustering-state checkpoint after the "
                        "accumulate phase and after every update iteration")
    p.add_argument("--resume-cluster", default=None, metavar="FILE",
                   help="resume clustering from a --checkpoint file (skips "
                        "the accumulate phase; the same output)")
    p.add_argument("--multihost", action="store_true",
                   help="multi-process data-parallel run over torch.distributed "
                        "(MC2_NPROCS/MC2_PROC_ID/MC2_COORD env; NCCL on "
                        "cuda:<process id>, gloo with --device cpu); requires "
                        "--recover")
    p.add_argument("--profile", nargs="?", const="/tmp/mc2_profile",
                   default=None, metavar="DIR",
                   help="capture a torch.profiler trace of the run into DIR "
                        "(CPU activity, and CUDA activity with --device "
                        "cuda; a Chrome trace, *.pt.trace.json, written "
                        "after the run)")
    return p


def load_sorted_points(
    train_files: List[str],
    notrain_files: List[str],
    k: int,
    datatype: str,
    single_file: bool,
    keep_seqs_train: bool = True,
    records_cache: Optional[dict] = None,
    count_device=None,
) -> tuple:
    """get_points for train + notrain files with the reference's sort-by-
    header-then-length (CRunner.cpp:504-544) and id assignment in final
    length order (CRunner.cpp:577-593); under MC2_DEVICE_COUNT the counts
    are built on `count_device` (None: the card).

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
                sets.append(build_point_set(recs, k, datatype, keep_seqs=keep,
                                            count_device=count_device))
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
    scorer: Optional[Scorer] = None    # TorchDeviceScorer, or a host scorer
    updater: Optional[TorchDeviceUpdater] = None
    accumulator: Optional[TorchDeviceAccumulator] = None
    phase: Optional[TorchDevicePhaseUpdater] = None
    clock: Optional[Clock] = None
    trained: Optional[PredictorModel] = None   # the model a training run made
    tables: Optional[TableStats] = None        # its pair tables' builder


def _session(ps: PointSet, model: CompiledModel, device, sim: float,
             delta: int, iterations: int) -> Optional[TorchDeviceSession]:
    """The run's device session, or None for a model with singles that have
    no device implementation or a pool that the kernels do not take: that
    one is clustered on the host scorer, and stderr says why, before any
    device work.  A model that the device loops do not take (plane
    singles) gets the scorer alone, with one stderr line."""
    why = scorer_refusal(model.singles) or store_refusal(ps)
    if why is not None:
        print(f"meshclust2-torch: {why}: clustering on the host scorer",
              file=sys.stderr)
        return None
    why = loop_refusal(model.singles)
    if why is not None:
        print(f"meshclust2-torch: {why} in the accumulate loop and update "
              f"batches: every batch goes through the device scorer",
              file=sys.stderr)
    with span("session.upload"):
        session = TorchDeviceSession(
            ps, model, device, sim,
            update_batch=not os.environ.get("MC2_NO_DEVICE_UPDATE_BATCH"),
            device_loop=not os.environ.get("MC2_NO_DEVICE_LOOP"),
            delta=delta, iterations=iterations)
    with span("session.warm"):
        session.warm_up()
    return session


def run(argv: Optional[List[str]] = None) -> ClusterRun:
    """Everything `main` does, returning the engine (its counters), the
    scorer, the accumulator, the phase, the updater, the clock stamps and,
    for a training run, the trained model and its table counters beside
    the exit code."""
    args = build_parser().parse_args(argv)
    if not args.profile:
        return _dispatch(args)
    import torch.profiler as tp

    from .utils.clock import prepare_ranges

    prepare_ranges()   # the spans' ranges, set up outside the trace
    activities = [tp.ProfilerActivity.CPU]
    if args.device == "cuda":
        activities.append(tp.ProfilerActivity.CUDA)
    # the trace is written when the context closes, after the run; the
    # closing line is printed as the JAX CLI prints it, in a finally
    try:
        with tp.profile(activities=activities,
                        on_trace_ready=tp.tensorboard_trace_handler(args.profile)):
            return _dispatch(args)
    finally:
        print(f"profile trace written to {args.profile}")


def _dispatch(args) -> ClusterRun:
    if args.multihost:
        from .parallel.multihost import run_multihost

        return run_multihost(args)
    train_files = list(args.files)
    if args.list_file:
        with open(args.list_file) as f:
            train_files += [ln.strip() for ln in f if ln.strip()]
    notrain_files = []
    if args.notrain_list:
        with open(args.notrain_list) as f:
            notrain_files = [ln.strip() for ln in f if ln.strip()]
    # de-dup like the reference's std::set normalization (CRunner.cpp:455-468)
    train_files = sorted(set(train_files))
    notrain_files = sorted(set(notrain_files) - set(train_files))
    if not train_files:
        build_parser().print_help()
        return ClusterRun(rc=1)
    device = resolve_device(args.device)
    if args.threads > 0:
        # the reference caps OpenMP parallelism via omp_set_num_threads
        # (CRunner.cpp:407-422); the port's lives in the native library
        from .native import set_num_threads

        set_num_threads(args.threads)
    # the run's clock is the current one until it returns
    with Clock(annotate=bool(args.profile)) as clock:
        return _run(args, train_files, notrain_files, device, clock)


def _run(args, train_files: List[str], notrain_files: List[str], device,
         clock: Clock) -> ClusterRun:
    recovered: Optional[PredictorModel] = None
    k = args.kmer
    similarity = args.identity
    datatype = DATATYPES[args.datatype] if args.datatype else None
    if args.recover:
        recovered = load_weights(args.recover)
        k = recovered.k
        similarity = recovered.id_cutoff
        datatype = recovered.datatype

    all_files = train_files + notrain_files
    records_cache = {}
    prog = Progress(len(all_files), "Reading in sequences")  # CRunner.cpp:58
    with span("setup.read"):
        for f in all_files:
            records_cache[f] = read_fasta(f, args.single_file)
            prog.step()
    prog.end()
    per_file_records = [records_cache[f] for f in all_files]

    if k == -1:
        try:
            k = find_k(per_file_records, len(train_files))
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

    with span("setup.count"):
        train_ps, all_ps = load_sorted_points(
            train_files, notrain_files, k, datatype, args.single_file,
            keep_seqs_train=recovered is None, records_cache=records_cache,
            count_device=device)
    records_cache.clear()

    session = None
    model: Optional[CompiledModel] = None
    if recovered is not None and all_ps is not None and all_ps.n:
        # the device bring-up before the read_in_points stamp (recover path)
        model = CompiledModel(recovered.classifier, bias=args.bias)
        with span("setup.session"):
            session = _session(all_ps, model, device, similarity,
                               args.delta, args.iterations)
    clock.stamp("read_in_points")

    if all_ps is None or all_ps.n == 0:
        print("No sequences found in input; writing empty output",
              file=sys.stderr)
        write_clstr(args.output, [])
        clock.stamp("done")
        return ClusterRun(rc=1, clock=clock)
    if recovered is None and (train_ps is None or train_ps.n == 0):
        print("No training sequences found", file=sys.stderr)
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
        with span("setup.session"):
            session = _session(all_ps, model, device, similarity,
                               args.delta, args.iterations)

    # clustering runs on all points, sequences dropped
    all_ps.seqs = None
    if session is None:
        # the JAX CLI's --device host scorer (meshclust2_tpu/cli.py:267-270)
        from .native import NativeScorer

        scorer = NativeScorer.create(all_ps, model) or HostScorer(all_ps, model)
        updater = acc = phase = None
    else:
        scorer, updater, acc, phase = (session.scorer, session.updater,
                                       session.accumulator, session.phase)
    engine = MeanShiftEngine(all_ps, model, similarity,
                             scorer=scorer, delta=args.delta,
                             iterations=args.iterations,
                             device_session=session)
    clusters = engine.run(clock=clock, checkpoint=args.checkpoint,
                          resume=args.resume_cluster)
    if acc is not None and acc.error is not None:
        raise RuntimeError("the device accumulate loop failed; the engine "
                           "finished on the host") from acc.error
    with span("update.write"):
        write_clstr(args.output, engine.to_output(clusters))
    clock.stamp("update")
    clock.stamp("done")
    return ClusterRun(rc=0, engine=engine, scorer=scorer, updater=updater,
                      accumulator=acc, phase=phase, clock=clock,
                      trained=trained, tables=tables)


def main(argv: Optional[List[str]] = None) -> int:
    return run(argv).rc


def _entry() -> None:  # console-script entry point
    sys.exit(main())


if __name__ == "__main__":
    _entry()
