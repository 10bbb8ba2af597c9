"""FASTA parsing and DNA encoding.

Replicates the sequence model of the reference's nonltr layer:
  - record splitting / whitespace-line skipping: ChromListMaker.cpp:117-165
  - --single-file joining with 50 Ns:            ChromListMaker.cpp:123-133
  - ambiguous-run segmentation:                  Chromosome.cpp:263-291
  - small-gap merge (<10 bp) + short-segment
    drop (<20 bp), only when len > 20:           Chromosome.cpp:298-353
  - 1 Mbp segment splitting:                     Chromosome.cpp:355-385
  - effective size = sum of segment lengths:     Chromosome.cpp:420-427
  - IUPAC one-digit encoding:                    ChromosomeOneDigitDna.cpp:48-68

All outputs are numpy arrays ready for batched device k-mer counting.
"""
from __future__ import annotations

import io as _io
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

# One-digit DNA codes (ChromosomeOneDigitDna.cpp:48-68).  Note the reference's
# quirky degenerate mappings (W->T, H->C, B->T, V->A, D->T, N->C, X->G) are
# preserved exactly, since they change k-mer counts.
_CODE_TABLE = np.full(256, -2, dtype=np.int8)  # -2 = invalid letter
for ch, code in [
    ("A", 0), ("C", 1), ("G", 2), ("T", 3),
    ("R", 2), ("Y", 1), ("M", 0), ("K", 3),
    ("S", 2), ("W", 3), ("H", 1), ("B", 3),
    ("V", 0), ("D", 3), ("N", 1), ("X", 2),
]:
    _CODE_TABLE[ord(ch)] = code

_SEG_LENGTH = 1_000_000  # Chromosome.cpp:29 (help(1000000, true))

# Proteinogenic amino-acid codes (ChromosomeOneDigitProtein.cpp:32-62):
# 22 residues 0..21 in alphabetical order, plus the ambiguity fallbacks
# B->D, Z->E, J->L.  No shipped reference binary reaches the protein path
# (Util::isDna is never false at runtime); provided for inventory
# completeness (SURVEY §2.4).
_PROTEIN_CODE_TABLE = np.full(256, -2, dtype=np.int8)
for _i, _ch in enumerate("ACDEFGHIKLMNOPQRSTUVWY"):
    _PROTEIN_CODE_TABLE[ord(_ch)] = _i
for _ch, _to in [("B", "D"), ("Z", "E"), ("J", "L")]:
    _PROTEIN_CODE_TABLE[ord(_ch)] = _PROTEIN_CODE_TABLE[ord(_to)]


def encode_protein_sequence(header: str, seq: str) -> "SequenceRecord":
    """Protein one-digit encoding (ChromosomeOneDigitProtein::buildCodes).

    The upstream class inherits Chromosome's DNA segmentation, where runs of
    'N' mark unread regions — but 'N' is asparagine in a protein alphabet,
    so that inherited behavior would corrupt protein segments (one more
    reason the path is dead upstream).  Here the whole sequence is one
    segment and every residue must be a valid amino-acid letter."""
    arr = np.frombuffer(seq.upper().encode("latin-1"), dtype=np.uint8)
    codes = _PROTEIN_CODE_TABLE[arr]
    if (codes == -2).any():
        bad = chr(arr[int(np.argmax(codes == -2))])
        raise ValueError(f"Invalid amino acid: {bad}")
    segments = np.array([[0, len(arr) - 1]], dtype=np.int64) if len(arr) else \
        np.zeros((0, 2), dtype=np.int64)
    return SequenceRecord(
        header=header,
        codes=codes,
        segments=segments,
        effective_size=len(arr),
        total_size=len(arr),
    )


@dataclass
class SequenceRecord:
    """A parsed FASTA record, encoded and segmented.

    codes holds the one-digit encoding for every position (including positions
    outside segments, mirroring ChromosomeOneDigit::encode which digitizes
    skipped intervals too); positions holding 'N' outside segments keep -1.
    """

    header: str                       # full header line including '>'
    codes: np.ndarray                 # int8 [L]
    segments: np.ndarray              # int64 [S, 2] inclusive (start, end)
    effective_size: int
    total_size: int
    # The reference's ChromListMaker::makeChromList (used by meshclust2's
    # find_k, CRunner.cpp:479-502, and Red's default k / GC scans,
    # RepeatsDetector.cpp:350-477) preallocates `size` spaces and then
    # APPENDS the sequence (Chromosome(uint64_t) ctor + appendToSequence,
    # Chromosome.cpp:18-25,88-97), doubling the buffer; spaces count as
    # valid bases, so its effective size is ~total+effective and its GC%
    # is halved.  These fields reproduce that observable behavior.
    ref_list_effective_size: int = 0
    gc_count: int = 0

    def segment_lengths(self) -> np.ndarray:
        if len(self.segments) == 0:
            return np.zeros(0, dtype=np.int64)
        return self.segments[:, 1] - self.segments[:, 0] + 1


def _find_raw_segments(is_n: np.ndarray) -> List[Tuple[int, int]]:
    """Maximal non-N runs, replicating Chromosome::removeAmbiguous
    (Chromosome.cpp:263-291) including its last-position quirk: a segment
    whose start is first set at the final index is dropped."""
    n = len(is_n)
    segs: List[Tuple[int, int]] = []
    if n == 0:
        return segs
    # Vectorized run detection.
    not_n = ~is_n
    if not not_n.any():
        return segs
    diff = np.diff(not_n.astype(np.int8))
    starts = list(np.nonzero(diff == 1)[0] + 1)
    ends = list(np.nonzero(diff == -1)[0])
    if not_n[0]:
        starts.insert(0, 0)
    if not_n[-1]:
        ends.append(n - 1)
    for s, e in zip(starts, ends):
        if s == n - 1:
            # Reference quirk: `if (base[i] != N && start == -1) start = i;`
            # wins over the close-at-end branch, so a run that *begins* at the
            # last base never emits a segment (Chromosome.cpp:267-284).
            continue
        segs.append((int(s), int(e)))
    return segs


def _merge_segments(segs: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """Merge gaps < 10 bp; drop merged segments < 20 bp
    (Chromosome.cpp:298-353)."""
    if not segs:
        return segs
    out: List[Tuple[int, int]] = []
    s, e = segs[0]
    for s1, e1 in segs[1:]:
        if s1 - e < 10:
            e = e1
        else:
            if e - s + 1 >= 20:
                out.append((s, e))
            s, e = s1, e1
    if e - s + 1 >= 20:
        out.append((s, e))
    return out


def _split_segments(segs: List[Tuple[int, int]], seg_length: int = _SEG_LENGTH) -> List[Tuple[int, int]]:
    """Split long segments into ~seg_length fragments
    (Chromosome.cpp:355-385).  k-mers spanning fragment boundaries are by
    construction not counted, matching the reference."""
    out: List[Tuple[int, int]] = []
    for s, e in segs:
        ln = e - s + 1
        if ln > seg_length:
            frag_num = ln // seg_length
            for h in range(frag_num):
                fs = s + h * seg_length
                fe = e if h == frag_num - 1 else fs + seg_length - 1
                out.append((fs, fe))
        else:
            out.append((s, e))
    return out


def encode_sequence(header: str, seq: str, can_merge: bool = True) -> SequenceRecord:
    """Uppercase, segment, and one-digit encode a raw sequence string.

    Mirrors Chromosome::help (Chromosome.cpp:130-154) followed by
    ChromosomeOneDigit::encode (ChromosomeOneDigit.cpp:79-133)."""
    try:
        arr = np.frombuffer(seq.upper().encode("ascii"), dtype=np.uint8)
    except UnicodeEncodeError as e:
        raise ValueError(
            f"Invalid nucleotide: non-ASCII character in {header}"
        ) from e
    codes = _CODE_TABLE[arr]
    is_n = arr == ord("N")
    segs = _find_raw_segments(is_n)
    if can_merge and len(arr) > 20:
        segs = _merge_segments(segs)
    segs = _split_segments(segs)
    if (codes == -2).any():
        bad = arr[codes == -2][0]
        raise ValueError(f"Invalid nucleotide: {chr(bad)!r} in {header}")
    # Positions that are 'N' and OUTSIDE every segment stay unencoded (the
    # reference leaves them as the raw 'N' char); we mark them -1.  'N's
    # *inside* merged segments encode to C via the table, which the table
    # already did.
    out_codes = codes.copy()
    if segs:
        inside = np.zeros(len(arr), dtype=bool)
        for s, e in segs:
            inside[s : e + 1] = True
        out_codes[is_n & ~inside] = -1
    else:
        out_codes[is_n] = -1
    seg_arr = np.asarray(segs, dtype=np.int64).reshape(-1, 2)
    eff = int((seg_arr[:, 1] - seg_arr[:, 0] + 1).sum()) if len(seg_arr) else 0
    # makeChromList-style effective size: the reference preallocates len(arr)
    # spaces and appends the letters, so its buffer is [spaces + letters]
    # with spaces counting as valid bases; segment over that doubled buffer.
    is_n_doubled = np.concatenate([np.zeros(len(arr), dtype=bool), is_n])
    dsegs = _find_raw_segments(is_n_doubled)
    if can_merge and 2 * len(arr) > 20:
        dsegs = _merge_segments(dsegs)
    dsegs = _split_segments(dsegs)
    ref_eff = sum(e - s + 1 for s, e in dsegs)
    gc_count = int(((arr == ord("C")) | (arr == ord("G"))).sum())
    return SequenceRecord(
        header=header,
        codes=out_codes,
        segments=seg_arr,
        effective_size=eff,
        total_size=len(arr),
        ref_list_effective_size=ref_eff,
        gc_count=gc_count,
    )


def iter_fasta(path: str):
    """Yield (header_line_with_gt, sequence_string) pairs.

    CRLF-safe; lines starting with space/tab are skipped
    (ChromListMaker.cpp:24-48,154).

    Fast path: whole-file bytes split on line-start '>' (records are the
    unit of Python-level work instead of lines).  Inputs with space/tab
    line starts or bare '\\r' line endings take the per-line path."""
    with open(path, "rb") as f:
        data = f.read()
    if (
        b"\n " in data
        or b"\n\t" in data
        or data[:1] in (b" ", b"\t")
        or (b"\r" in data and data.count(b"\r") != data.count(b"\r\n"))
    ):
        yield from _iter_fasta_lines(data)
        return
    if b"\r" in data:
        data = data.replace(b"\r\n", b"\n")
    # first '>' at a line start; anything before it is dropped (the line
    # parser never yields pre-header sequence lines either)
    start = data.find(b">")
    while start > 0 and data[start - 1 : start] != b"\n":
        start = data.find(b">", start + 1)
    if start == -1:
        return
    for part in data[start + 1 :].split(b"\n>"):
        nl = part.find(b"\n")
        if nl == -1:
            header, body = part, b""
        else:
            header, body = part[:nl], part[nl + 1 :]
        yield ">" + header.decode("utf-8"), body.replace(b"\n", b"").decode("utf-8")


def _iter_fasta_lines(data: bytes):
    header: Optional[str] = None
    chunks: List[str] = []
    for raw in data.decode("utf-8").split("\n"):
        line = raw.rstrip("\r")
        if line.startswith(">"):
            if header is not None:
                yield header, "".join(chunks)
            header = line
            chunks = []
        elif line[:1] in (" ", "\t"):
            continue
        else:
            chunks.append(line)
    if header is not None:
        yield header, "".join(chunks)


def read_fasta(path: str, single_file: bool = False) -> List[SequenceRecord]:
    """Parse a FASTA file into encoded records.

    single_file=True joins every record with 50 'N's into one record keeping
    the first header (ChromListMaker.cpp:117-165)."""
    if not single_file:
        fast = _read_fasta_fast(path)
        if fast is not None:
            return fast
    records = list(iter_fasta(path))
    if not records:
        return []
    if single_file:
        header = records[0][0]
        joined = ("N" * 50).join(seq for _, seq in records)
        records = [(header, joined)]
    return encode_records(records)


def _parse_fast(data: bytes):
    """Whole-buffer FASTA parse via the single-pass native scanner:
    (headers, seq_blob uint8, offsets int64 [n+1]) with newlines/CR
    stripped, or None when the input needs the per-line path (space/tab
    line starts, bare CR, non-ASCII) or the native library is unavailable.

    Byte-for-byte the same records as iter_fasta on every input it
    accepts.  (An earlier vectorized-numpy fallback body was removed: it
    only ran when the native library was missing, and then
    encode_batch_arrays — which needs the same library — always discarded
    its result, so it was pure wasted work on exactly the environments it
    claimed to serve.)"""
    if not data or not data.isascii():
        return None
    from ..native import fasta_scan

    scanned = fasta_scan(data)
    if scanned is None:
        return None
    hdr_ranges, blob, offsets = scanned
    headers = [data[hs:he].decode() for hs, he in hdr_ranges.tolist()]
    return headers, blob, offsets


def _read_fasta_fast(path: str) -> Optional[List[SequenceRecord]]:
    """read_fasta without the bytes->str->bytes round trip: vectorized
    parse straight into the native batch encoder.  Returns None whenever
    the input or environment needs the existing paths (which re-read the
    file — acceptable for those rare cases)."""
    from ..native import encode_batch_arrays

    with open(path, "rb") as f:
        data = f.read()
    parsed = _parse_fast(data)
    if parsed is None:
        return None
    headers, blob, offsets = parsed
    if not headers:
        return []
    batch = encode_batch_arrays(blob, offsets)
    if batch is None:  # native lib missing or invalid letters: slow path
        return None
    return _records_from_batch(headers, batch)


class RecordList(list):
    """A list of SequenceRecords whose code/segment arrays are views into
    one encoded batch blob; `batch` carries (codes, offsets, segs,
    seg_offsets) so downstream native calls can skip re-packing."""

    batch = None


def _records_from_batch(headers, batch) -> "RecordList":
    """Slice a native encode_batch result into per-record views.

    Per-record numpy scalar indexing/int() conversions are hoisted into
    bulk .tolist() calls — at 1M records they were most of this loop."""
    codes, offsets, segs, seg_offsets, meta = batch
    out = RecordList()
    out.batch = (codes, offsets, segs, seg_offsets)
    offs = offsets.tolist()
    soffs = seg_offsets.tolist()
    metal = meta.tolist()
    segs2 = segs.reshape(-1, 2)
    for i, h in enumerate(headers):
        o0, o1 = offs[i], offs[i + 1]
        m = metal[i]
        out.append(
            SequenceRecord(
                header=h,
                codes=codes[o0:o1],
                segments=segs2[soffs[i] : soffs[i + 1]],
                effective_size=m[1],
                total_size=o1 - o0,
                ref_list_effective_size=m[2],
                gc_count=m[3],
            )
        )
    return out


def encode_records(records) -> List[SequenceRecord]:
    """Batch-encode (header, sequence) pairs, using the native encoder when
    available (exact same segmentation semantics as encode_sequence)."""
    from ..native import encode_batch

    raw = [s.encode("ascii", "replace") for _, s in records]
    batch = encode_batch(raw)
    if batch is None:
        return [encode_sequence(h, s) for h, s in records]
    return _records_from_batch([h for h, _ in records], batch)


def acgt_only(seq: str) -> str:
    """Strip every non-ACGT character (Loader.cpp:111-120)."""
    keep = set("ACGT")
    return "".join(c for c in seq if c in keep)


def codes_to_acgt(codes: np.ndarray) -> str:
    """Decode one-digit codes 0..3 back to an ACGT string
    (Predictor.cpp:571-595 bin->ACGT with 'N'->'C')."""
    lut = np.frombuffer(b"ACGT", dtype=np.uint8)
    arr = np.asarray(codes)
    if (arr < 0).any():
        arr = np.where(arr < 0, 1, arr)  # 'N' -> 'C' (Predictor.cpp:587-589)
    return lut[arr.astype(np.intp)].tobytes().decode("ascii")
