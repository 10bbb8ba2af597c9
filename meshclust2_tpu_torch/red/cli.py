"""Red — repeat detector CLI.

Rebuild of the reference's third executable (RepeatsDetector.cpp): genome
k-mer enrichment scoring, Gaussian-maxima candidate detection, HMM training,
and three-strand scanning (forward, reverse complement, reverse) producing
masked sequences (-msk), repeat coordinates (-rpt), scores (-sco),
candidates (-cnd), the adjusted-count table (-tbl) and the HMM (-hmo).

Flag-pair interface and defaults mirror RepeatsDetector.cpp:32-56,334-477:
k = floor(log4(genome size)) clamped to [12, 15], order = floor(k/2)-1,
threshold 2 (1 adjusted to 1.5), minObs 3, Gaussian half-width from GC
content (20 inside 33..67%, else 40).
"""
from __future__ import annotations

import math
import os
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..io.fasta import SequenceRecord, read_fasta
from .table import EnrichmentTable
from .scorer import ChromScores
from .detector import detect_chrom
from .hmm import HMM

FRMT_POS = 1
FRMT_BED = 2

_VALID = {"-gnm", "-dir", "-len", "-ord", "-gau", "-thr", "-min", "-tbl",
          "-sco", "-cnd", "-rpt", "-msk", "-frm", "-hmo", "-hmi", "-seq",
          "-sci"}


def _fa_files(directory: str) -> List[str]:
    out = sorted(
        os.path.join(directory, f)
        for f in os.listdir(directory)
        if f.endswith(".fa")
    )
    return out


def _nickname(path: str) -> str:
    base = os.path.basename(path)
    dot = base.rfind(".")
    return base[:dot] if dot > 0 else base


def _rc_record(rec: SequenceRecord) -> SequenceRecord:
    """Reverse complement (ChromosomeOneDigitDna::makeRC semantics: codes
    complemented and reversed, segments mirrored)."""
    n = len(rec.codes)
    codes = rec.codes[::-1].copy()
    valid = codes >= 0
    codes[valid] = 3 - codes[valid]
    segs = np.array(
        [[n - 1 - e, n - 1 - s] for s, e in rec.segments[::-1]], dtype=np.int64
    ).reshape(-1, 2)
    return SequenceRecord(rec.header, codes, segs, rec.effective_size, rec.total_size)


def _r_record(rec: SequenceRecord) -> SequenceRecord:
    """Plain reverse (makeR)."""
    n = len(rec.codes)
    codes = rec.codes[::-1].copy()
    segs = np.array(
        [[n - 1 - e, n - 1 - s] for s, e in rec.segments[::-1]], dtype=np.int64
    ).reshape(-1, 2)
    return SequenceRecord(rec.header, codes, segs, rec.effective_size, rec.total_size)


def _merge_regions(regions: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Scanner::merge (Scanner.cpp:169-197): fold overlapping neighbors."""
    out: List[List[int]] = []
    for s, e in regions:
        if out and not (out[-1][1] < s or e < out[-1][0]):
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _mirror_regions(regions: List[Tuple[int, int]], n: int) -> List[Tuple[int, int]]:
    """Scanner::makeForwardCoordinates (Scanner.cpp:249-270)."""
    return [(n - 1 - e, n - 1 - s) for s, e in regions][::-1]


def _merge_sorted(a: List[Tuple[int, int]], b: List[Tuple[int, int]]):
    """Scanner::mergeWithOtherRegions (Scanner.cpp:199-247): merge two
    start-sorted lists, then fold overlaps."""
    out = []
    i = j = 0
    while i < len(a) and j < len(b):
        if a[i][0] < b[j][0]:
            out.append(a[i]); i += 1
        else:
            out.append(b[j]); j += 1
    out.extend(a[i:])
    out.extend(b[j:])
    return _merge_regions(out)


class RedScanner:
    """Scanner equivalent: log-scores a strand and decodes repeat regions."""

    def __init__(self, hmm: HMM, k: int, rec: SequenceRecord, table: EnrichmentTable):
        self.k = k
        scorer = ChromScores(rec, table)
        scorer.take_log(hmm.base)
        self.scores = scorer.scores
        regions: List[Tuple[int, int]] = []
        for s, e in rec.segments:
            regions.extend(hmm.decode_segment(self.scores, int(s), int(e)))
        # extendByK within segments (Scanner.cpp:103-167)
        extended = []
        seg_iter = list(rec.segments)
        for s, e in regions:
            seg_end = next(
                (int(se) for ss, se in seg_iter if ss <= s <= se), None
            )
            new_e = e + k - 1
            if seg_end is not None and new_e > seg_end:
                new_e = seg_end
            extended.append((s, new_e))
        self.regions = _merge_regions(extended)


def scan_record(rec: SequenceRecord, hmm: HMM, table: EnrichmentTable, k: int):
    """Forward + RC + R scans merged into forward coordinates
    (RepeatsDetector.cpp:165-186)."""
    n = len(rec.codes)
    fwd = RedScanner(hmm, k, rec, table).regions
    rc = RedScanner(hmm, k, _rc_record(rec), table).regions
    fwd = _merge_sorted(fwd, _mirror_regions(rc, n))
    rev = RedScanner(hmm, k, _r_record(rec), table).regions
    fwd = _merge_sorted(fwd, _mirror_regions(rev, n))
    return fwd


def write_regions(path: str, header: str, regions, frmt: int, append: bool):
    with open(path, "a" if append else "w") as f:
        for s, e in regions:
            if frmt == FRMT_POS:
                f.write(f"{header}:{s}-{e + 1}\n")
            else:
                f.write(f"{header}\t{s}\t{e + 1}\n")


def write_masked(path: str, header: str, raw_seq: str, regions, append: bool):
    # lowercase repeat regions via an ASCII |0x20 on a uint8 view (letters
    # only appear here), avoiding per-character Python loops on Mbp inputs
    buf = np.frombuffer(raw_seq.encode("ascii"), dtype=np.uint8).copy()
    for s_, e_ in regions:
        buf[s_ : e_ + 1] |= 0x20
    s = buf.tobytes().decode("ascii")
    with open(path, "a" if append else "w") as f:
        f.write(header + "\n")
        for i in range(0, len(s), 50):
            f.write(s[i : i + 50] + "\n")


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 0 or len(argv) % 2 != 0:
        print("Argument pairs of the form: -flag value are required.", file=sys.stderr)
        return 1
    param: Dict[str, str] = {}
    for i in range(0, len(argv), 2):
        if argv[i] not in _VALID:
            print(f"Invalid argument: {argv[i]}", file=sys.stderr)
            return 1
        param[argv[i]] = argv[i + 1]

    if "-gnm" not in param:
        if "-hmi" in param:
            # scan-with-pretrained-HMM mode: the reference loads the model
            # and sequence, then its scores-file Scanner constructor throws
            # unconditionally ("ToDo" in Scanner.cpp:11-16) — mirror that
            # observable behavior after validating the inputs
            for req in ("-seq", "-sci"):
                if req not in param:
                    print(f"-hmi requires {req}", file=sys.stderr)
                    return 1
            HMM.read(param["-hmi"])
            read_fasta(param["-seq"])
            print("Scanning file of scores is temporarily disabled.",
                  file=sys.stderr)
            return 1
        print("A mode is required: training and scanning (-gnm).", file=sys.stderr)
        return 1
    genome_dir = param["-gnm"]
    files = _fa_files(genome_dir)
    per_file = {f: read_fasta(f) for f in files}
    all_records = [r for f in files for r in per_file[f]]
    if not all_records or all(r.total_size == 0 for r in all_records):
        print(f"No sequences found under {genome_dir} (.fa files required).",
              file=sys.stderr)
        return 1

    # k default: floor(log4 genome), clamped to [12, 15]
    # (RepeatsDetector.cpp:350-394)
    if "-len" in param:
        k = int(param["-len"])
    else:
        # makeChromList effective sizes (space-doubled, see
        # SequenceRecord.ref_list_effective_size) — RepeatsDetector.cpp:350-394
        genome_length = sum(r.ref_list_effective_size for r in all_records)
        k = int(math.floor(math.log(genome_length) / math.log(4.0)))
        k = min(k, 15)
        k = max(k, 12)
        print(f"The recommended k is {k}.")
    order = int(param.get("-ord", math.floor(k / 2.0) - 1))
    t = float(int(param.get("-thr", "2")))
    if int(t) == 1:
        t = 1.5
    min_obs = int(param.get("-min", "3"))
    frmt = int(param.get("-frm", str(FRMT_POS)))
    if "-gau" in param:
        s_width = int(param["-gau"])
    else:
        # literal C/G letters over the makeChromList effective size (whose
        # space-preallocation bug halves the percentage — most genomes land
        # below 33% and get the wide mask, RepeatsDetector.cpp:446-477)
        gc = sum(r.gc_count for r in all_records)
        eff = sum(r.ref_list_effective_size for r in all_records)
        gc_pct = 100.0 * gc / max(1, eff)
        s_width = 20 if 33 <= gc_pct <= 67 else 40
        print(f"Using the default half width: {s_width} based on the GC content of {gc_pct:g}")

    # Stage 1: table
    print("Stage 1: Building the table ...")
    table = EnrichmentTable(all_records, k, order, min_obs)
    if "-tbl" in param:
        table.print_table(param["-tbl"])

    # Stage 2: percentage of low scores (Trainer.cpp:99-135)
    print("Stage 2: Calculating the percentage ...")
    eff_size = 0.0
    count_le = 0.0
    chrom_scores: Dict[int, ChromScores] = {}
    for idx, rec in enumerate(all_records):
        cs = ChromScores(rec, table)
        chrom_scores[idx] = cs
        eff_size += rec.effective_size
        count_le += cs.count_less_or_equal(t)
    if eff_size == 0:
        print("No valid sequence segments found (inputs are all Ns or "
              "shorter than 20 bp).", file=sys.stderr)
        return 1
    p = 100.0 * count_le / eff_size
    print(f"The percentage is {p}")
    if p < 52.5:
        p = 52.5
        print(f"The percentage is increased to {p}")

    # Stage 3: candidates + HMM training (Trainer.cpp:140-260)
    print("Stage 3: Training ...")
    t_detector = t + 0.1
    hmm_base = t
    max_score = max((cs.max for cs in chrom_scores.values()), default=1)
    if max_score <= 0:
        print("No k-mer scored above zero (genome too small for -len/-min?); "
              "nothing to train on.", file=sys.stderr)
        return 1
    state_count = 2 * (math.ceil(math.log(max_score) / math.log(hmm_base)) + 1)
    hmm = HMM(hmm_base, state_count)

    cnd_dir = param.get("-cnd")
    idx = 0
    for f in files:
        first_in_file = True
        for rec in per_file[f]:
            cs = chrom_scores[idx]
            candidates = detect_chrom(
                s_width, 10, 0, t_detector, p, s_width, cs.scores, rec.segments
            )
            if cnd_dir:
                cnd_file = os.path.join(cnd_dir, _nickname(f) + ".cnd")
                with open(cnd_file, "w" if first_in_file else "a") as cf:
                    for cs_, ce_ in candidates:
                        cf.write(f"{rec.header}:{cs_}-{ce_ + 1} \n")
            cs.take_log(t)
            hmm.train(cs.scores, [tuple(x) for x in rec.segments], candidates)
            first_in_file = False
            idx += 1
    hmm.normalize()
    if "-hmo" in param:
        hmm.write(param["-hmo"])

    # Stage 4: scanning (RepeatsDetector.cpp:136-230)
    print("Stage 4: Scanning ...")
    scan_files = list(files)
    if "-dir" in param:
        scan_files += _fa_files(param["-dir"])
        for f in scan_files:
            if f not in per_file:
                per_file[f] = read_fasta(f)
    for f in scan_files:
        nick = _nickname(f)
        raw_by_idx = None
        if "-msk" in param:
            raw_by_idx = [
                (h, seq) for h, seq in _raw_records(f)
            ]
        for h, rec in enumerate(per_file[f]):
            regions = scan_record(rec, hmm, table, k)
            append = h > 0
            if "-sco" in param:
                cs = ChromScores(rec, table)
                with open(
                    os.path.join(param["-sco"], nick + ".scr"),
                    "a" if append else "w",
                ) as sf:
                    cs.write(sf, rec.header)
            if "-rpt" in param:
                write_regions(
                    os.path.join(param["-rpt"], nick + ".rpt"),
                    rec.header, regions, frmt, append,
                )
            if "-msk" in param:
                hdr, raw = raw_by_idx[h]
                write_masked(
                    os.path.join(param["-msk"], nick + ".msk"),
                    hdr, raw, regions, append,
                )
    return 0


def _raw_records(path: str):
    from ..io.fasta import iter_fasta

    for h, seq in iter_fasta(path):
        yield h, seq.upper()


def _entry() -> None:  # console-script entry point
    sys.exit(main())


if __name__ == "__main__":
    _entry()
