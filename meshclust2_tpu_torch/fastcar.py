"""fastcar — all-vs-query identity search/estimation on an NVIDIA card.

    python -m meshclust2_tpu_torch.fastcar --device cuda --recover W.txt \\
        -q queries.fasta -o out.search db.fasta
    python -m meshclust2_tpu_torch.fastcar --device cpu --id 0.9 \\
        -q queries.fasta db.fasta

The port of meshclust2_tpu/fastcar.py (the reference's FC_Runner.cpp): a
GLM classifier gates candidate (database, query) pairs inside a length
window, and an optional GLM regression head estimates percent identity for
the survivors.  The output is the reference's `<output>N` TSV format
(query  db  identity%), every match in `<output>0`.

Each db-chunk x query-chunk block is one flat batch of window pairs.  With
--device cuda (the default; it never falls back) or cpu, a block goes
through cluster/device_search.py:TorchDeviceSearch: the fused
pair-statistics kernel in pair form (its plain PyTorch version on the CPU),
the GLM sums read back, and every pair near a decision edge or a printed
digit re-checked by the host route's own scorer, so the output equals the
JAX package's host route byte for byte.  There is no MC2_FASTCAR_DEVICE
switch: the device route is the default.  A block the kernels do not take
(uint32/uint64 histograms, or counts outside the exact-integer envelope,
`device_store.store_refusal`) is searched by the host route, with one
stderr line naming the reason; training builds its pair tables on the
same device (train/device_tables.py), on the host for such a pool and
for `--feat slow`, whose log divergences the pair statistics do not derive
(as the JAX package builds them).  The search takes those singles on the
card (the fused kernel's FULL instantiation, with error bounds on the
sums); a recovered model that the device loops do not take (plane
singles, as the JAX fastcar's DeviceUpdater refuses them, or a single with
no device implementation: `device_features.loop_refusal`) is searched by
the host route, with one stderr line naming the features.
"""
from __future__ import annotations

import argparse
import math
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .cli import DATATYPES, MUT_TYPES
from .cluster.device_search import HostOracle, TorchDeviceSearch, host_search
from .cluster.device_store import store_refusal
from .features import flags as F
from .io.fasta import encode_sequence, iter_fasta
from .kmer.counting import (PointSet, build_point_set, concat_point_sets,
                            largest_pseudocount, select_datatype)
from .model.classifier import CompiledModel
from .model.weights import (PRED_MODE_CLASS, PRED_MODE_REGR, PredictorModel,
                            load_weights, save_weights)
from .ops.device_features import loop_refusal
from .runtime import resolve_device

FEAT_SETS = {"fast": F.PRED_FEAT_FAST, "slow": F.PRED_FEAT_FAST | F.PRED_FEAT_DIV}
MODES = {"c": PRED_MODE_CLASS, "r": PRED_MODE_REGR,
         "rc": PRED_MODE_CLASS | PRED_MODE_REGR,
         "cr": PRED_MODE_CLASS | PRED_MODE_REGR}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fastcar-torch",
                                description="all-vs-query identity search "
                                            "on an NVIDIA GPU")
    p.add_argument("files", nargs="*", help="database FASTA files")
    p.add_argument("-q", "--query", action="append", default=[], required=False)
    p.add_argument("--id", type=float, default=-1.0, dest="identity")
    p.add_argument("-k", "--kmer", type=int, default=-1)
    p.add_argument("--datatype", choices=sorted(DATATYPES), default=None)
    p.add_argument("-c", "--chunk", type=int, default=10000)
    p.add_argument("--dump", default=None)
    p.add_argument("--no-format", "--noformat", dest="noformat", action="store_true")
    p.add_argument("-o", "--output", default="output.search")
    p.add_argument("-r", "--recover", default=None)
    p.add_argument("-f", "--feat", choices=sorted(FEAT_SETS), default="fast")
    p.add_argument("-m", "--mode", choices=sorted(MODES), default="rc")
    p.add_argument("-s", "--sample", type=int, default=300)
    p.add_argument("--mut-type", choices=sorted(MUT_TYPES), default="single")
    p.add_argument("-t", "--threads", type=int, default=0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where training's pair tables and the search's "
                        "pairs run; cpu runs the kernels' plain PyTorch "
                        "versions")
    return p


def format_header(hdr: str) -> str:
    """(FC_Runner.cpp:410-424): strip '>' and truncate after first space/tab
    (keeping the delimiter)."""
    b = 1 if hdr.startswith(">") else 0
    length = len(hdr)
    for i in range(b, len(hdr)):
        if hdr[i] in (" ", "\t"):
            length = i + 1
            break
    return hdr[b:length]


def bin_search(lengths: np.ndarray, length: int) -> int:
    """The reference's window lower-bound search with its quirks
    (FC_Runner.cpp:390-408)."""
    def rec(begin: int, last: int) -> int:
        if last < begin:
            return 0
        idx = begin + (last - begin) // 2
        l = int(lengths[idx])
        if l == length:
            while idx > 0 and int(lengths[idx - 1]) == length:
                idx -= 1
            return idx
        elif l > length:
            if begin == idx:
                return idx
            return rec(begin, idx - 1)
        else:
            return rec(idx + 1, last)

    n = len(lengths)
    return rec(0, n - 1) if n else 0


def load_chunks(files: List[str], k: int, datatype: str, chunk: int,
                count_device=None):
    """Stream records into PointSet chunks of ~chunk sequences (under
    MC2_DEVICE_COUNT counted on `count_device`, None: the card)."""
    buf = []
    for fpath in files:
        for header, seq in iter_fasta(fpath):
            buf.append(encode_sequence(header, seq))
            if len(buf) >= chunk:
                yield build_point_set(buf, k, datatype, count_device=count_device)
                buf = []
    if buf:
        yield build_point_set(buf, k, datatype, count_device=count_device)


@dataclass
class SearchStats:
    """What the search did over a run."""

    blocks: int = 0
    pairs: int = 0               # window pairs
    device_blocks: int = 0       # blocks through TorchDeviceSearch
    rechecked_c: int = 0         # classifier pairs the oracle re-decided
    rechecked_r: int = 0         # regression values the oracle re-computed
    host_reasons: List[str] = field(default_factory=list)  # refused blocks
    # host wall seconds of `search`: the window pairs' index arrays, their
    # scoring (on the device, or by the host route, re-checks included),
    # the output lines
    pairs_seconds: float = 0.0
    score_seconds: float = 0.0
    write_seconds: float = 0.0


def search(
    db_ps: PointSet,
    q_ps: PointSet,
    model_c: Optional[CompiledModel],
    model_r: Optional[CompiledModel],
    similarity: float,
    out,
    delim: str,
    do_format: bool,
    device,
    stats: SearchStats,
    host_why: Optional[str] = None,
) -> int:
    """One db-chunk x query-chunk block (FC_Runner.cpp:426-471), batched:
    on `device` when the kernels take the block and the models (host_why,
    the models' `loop_refusal`, is None), else by the host route."""
    from .native import sort_perm

    t0 = time.perf_counter()
    order = sort_perm(db_ps.lengths.astype(np.uint64))
    db = db_ps.subset(order)
    # per-query windows: quirky bin_search for the start (reference
    # semantics), one vectorized searchsorted for the ends (db.lengths is
    # ascending, so the reference's linear `while lengths[end] <= end_length`
    # walk lands on the same index)
    q_lens = q_ps.lengths
    end_lengths = (q_lens / similarity).astype(np.int64)
    starts = np.array(
        [bin_search(db.lengths, int(l * similarity)) for l in q_lens],
        dtype=np.int64,
    )
    ends = np.maximum(
        starts, np.searchsorted(db.lengths, end_lengths, side="right")
    )
    per_q = ends - starts
    total = int(per_q.sum())
    stats.blocks += 1
    stats.pairs += total
    if total == 0:
        stats.pairs_seconds += time.perf_counter() - t0
        return 0
    q_arr = np.repeat(np.arange(q_ps.n, dtype=np.int64), per_q)
    a_arr = np.repeat(starts, per_q) + (
        np.arange(total, dtype=np.int64)
        - np.repeat(np.cumsum(per_q) - per_q, per_q)
    )
    # one combined point set, db rows first and the queries after, serves
    # the store on the card and the host route's scorers alike
    combined = concat_point_sets([db, q_ps])
    b_arr = q_arr + db.n
    oracle = HostOracle(combined, model_c, model_r)
    t1 = time.perf_counter()
    stats.pairs_seconds += t1 - t0
    why = host_why or store_refusal(combined)
    if why is not None:
        if host_why is None:   # the models' reason is printed once, by _run
            print(f"fastcar-torch: {why}: searching on the host scorer",
                  file=sys.stderr)
        stats.host_reasons.append(why)
        keep, sim = host_search(oracle, a_arr, b_arr)
    else:
        dev = TorchDeviceSearch(combined, model_c, model_r, device)
        keep, sim = dev.search(a_arr, b_arr, oracle)
        stats.device_blocks += 1
        stats.rechecked_c += dev.rechecked_c
        stats.rechecked_r += dev.rechecked_r
    t2 = time.perf_counter()
    stats.score_seconds += t2 - t1
    n_pos = 0
    for i in np.nonzero(keep)[0]:
        n_pos += 1
        s = sim[i]
        if s > 0:
            qh = q_ps.headers[int(q_arr[i])]
            dh = db.headers[int(a_arr[i])]
            if do_format:
                qh, dh = format_header(qh), format_header(dh)
            out.write(f"{qh}{delim}{dh}{delim}{100 * s:g}\n")
    stats.write_seconds += time.perf_counter() - t2
    return n_pos


def mem_used(prefix: str) -> None:
    """VmSize print, matching the reference's observability surface
    (FC_Runner.cpp:43-58): ``<prefix>: used memory: <kB> KB``."""
    result = -1
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmSize:"):
                    result = int(line.split()[1])
                    break
    except OSError:
        pass
    print(f"{prefix}: used memory: {result} KB")


@dataclass
class FastcarRun:
    rc: int
    positives: int = 0
    search_seconds: float = 0.0      # `before loop` to `after loop`
    stats: SearchStats = field(default_factory=SearchStats)
    trained: Optional[PredictorModel] = None   # the model a training run made


def run(argv: Optional[List[str]] = None) -> FastcarRun:
    """Everything `main` does, returning the search's counters and window
    and, for a training run, the trained model beside the exit code."""
    args = build_parser().parse_args(argv)
    if not args.files or not args.query:
        build_parser().print_help()
        return FastcarRun(rc=1)
    return _run(args, resolve_device(args.device))


def _run(args, device) -> FastcarRun:
    similarity = args.identity
    mode = MODES[args.mode]

    recovered: Optional[PredictorModel] = None
    k = args.kmer
    datatype = DATATYPES[args.datatype] if args.datatype else None
    if args.recover:
        recovered = load_weights(args.recover)
        k = recovered.k
        datatype = recovered.datatype
        similarity = recovered.id_cutoff
        mode = recovered.mode

    # The first <=10000 sequences serve both the k/datatype scan AND the
    # training-template pool — the reference caps the pool at 10k regardless
    # of flags (FC_Runner.cpp:106-125: `cap = 10000`; only --recover skips
    # the read and clears the pool).
    sample_records = []
    if not args.recover:
        count = 0
        for fpath in args.files:
            for header, seq in iter_fasta(fpath):
                sample_records.append(encode_sequence(header, seq))
                count += 1
                if count >= 10000:
                    break
            if count >= 10000:
                break
    if k == -1:
        if not sample_records or all(r.total_size == 0 for r in sample_records):
            print("fastcar: no sequences found in the database input",
                  file=sys.stderr)
            return FastcarRun(rc=1)
        total = sum(r.total_size for r in sample_records)
        avg = total / max(1, len(sample_records))
        k = max(int(math.ceil(math.log(avg) / math.log(4)) - 1), 2)
    print(f"K: {k}")
    if datatype is None:
        largest = largest_pseudocount(sample_records, k)
        datatype = select_datatype(largest)
    print(f"Using {datatype} histograms")

    mem_used("before do_run")  # FC_Runner.cpp:480
    trained = None
    if recovered is not None:
        model = recovered
    else:
        if similarity < 0 and (mode & PRED_MODE_CLASS):
            print("Classification specified, but no identity score given (--id)")
            return FastcarRun(rc=1)
        if similarity < 0:
            similarity = 0.9
        if not sample_records:
            print("fastcar: no sequences found in the database input",
                  file=sys.stderr)
            return FastcarRun(rc=1)
        # template selection over the <=10k pool: unstable std::sort by RAW
        # length, C-round()ed stride to ~sample templates
        # (FC_Runner.cpp:487-507)
        from .native import sort_perm

        raw_lens = np.array([r.total_size for r in sample_records],
                            dtype=np.uint64)
        recs = [sample_records[j] for j in sort_perm(raw_lens)]
        print(f"sample_size: {args.sample}")  # FC_Runner.cpp:491
        increment = max(1.0, len(recs) / args.sample)
        idxs = []
        i = 0.0
        while math.floor(i + 0.5) < len(recs):  # C round(), positive domain
            idxs.append(int(math.floor(i + 0.5)))
            i += increment
        tmpl_ps = build_point_set([recs[j] for j in idxs], k, datatype, keep_seqs=True,
                                  count_device=device)
        mem_used("after selection")  # FC_Runner.cpp:510
        print(f"TRpoints.size(): {tmpl_ps.n}")  # FC_Runner.cpp:512
        from .train.predictor import train_predictor

        mem_used("before predictor training")  # FC_Runner.cpp:539
        model = trained = train_predictor(
            tmpl_ps,
            k=k,
            identity=similarity,
            datatype=datatype,
            feat_flags=FEAT_SETS[args.feat],
            mut_type=MUT_TYPES[args.mut_type],
            min_feat=4,
            max_feat=5,
            n_samples=10,
            n_templates=args.sample,
            mode=mode,
            device=device,
        )
        if args.dump:
            save_weights(args.dump, model)
            return FastcarRun(rc=0, trained=trained)
        save_weights("weights.txt", model)

    model_c = CompiledModel(model.classifier) if model.classifier else None
    model_r = CompiledModel(model.regressor) if model.regressor else None
    host_why = loop_refusal([s for m in (model_c, model_r) if m is not None
                              for s in m.singles])
    if host_why is not None:
        print(f"fastcar-torch: {host_why}: searching on the host scorer",
              file=sys.stderr)

    delim = "!" if args.noformat else "\t"
    n_pos = 0
    stats = SearchStats()
    # the reference opens one `<output>N` ofstream per OpenMP thread
    # upfront (FC_Runner.cpp:556-560) and each thread appends its own
    # matches; WHICH file a match lands in is scheduler-dependent there.
    # This implementation creates the same file set for -t N but writes
    # all matches (deterministically) to `<output>0`.
    for t in range(1, max(args.threads, 1)):
        open(f"{args.output}{t}", "w").close()
    mem_used("before loop")  # FC_Runner.cpp:571
    t0 = time.perf_counter()
    with open(f"{args.output}0", "w") as out:
        for q_ps in load_chunks(args.query, k, datatype, args.chunk, device):
            for db_ps in load_chunks(args.files, k, datatype, args.chunk, device):
                n_pos += search(
                    db_ps, q_ps, model_c, model_r,
                    similarity if similarity > 0 else model.id_cutoff,
                    out, delim, not args.noformat, device, stats, host_why,
                )
            mem_used("mid loop")  # FC_Runner.cpp:602
    seconds = time.perf_counter() - t0
    mem_used("after loop")  # FC_Runner.cpp:604
    print(f"# of predicted positive: {n_pos}")
    return FastcarRun(rc=0, positives=n_pos, search_seconds=seconds,
                      stats=stats, trained=trained)


def main(argv: Optional[List[str]] = None) -> int:
    return run(argv).rc


def _entry() -> None:  # console-script entry point
    sys.exit(main())


if __name__ == "__main__":
    _entry()
