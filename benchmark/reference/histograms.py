"""A FASTA pool's k-mer histograms, in PyTorch, and the reference's row order.

The pools the benchmark writes hold A, C, G and T only, so each record is
one segment and its length is its number of bases (Chromosome.cpp:263-353
leaves such a record whole).  A histogram counts every k-mer window inside
the record by its big-endian base-4 index (KmerHashTable.cpp:49-51), plus
one (the table's initial value, Loader.cpp:141), saturated at the
datatype's largest value.  The rows are then ordered as CRunner.cpp:
538-539 orders them: by header, then by length with std::sort.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from .introsort import sort_perm

_CODE = np.full(256, 255, dtype=np.uint8)
for _i, _ch in enumerate(b"ACGT"):
    _CODE[_ch] = _i


@dataclass
class Records:
    headers: List[str]        # with the leading '>'
    codes: np.ndarray         # uint8, every record's bases as 0..3, concatenated
    offsets: np.ndarray       # int64 [N + 1]

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)


def read_fasta(path: str) -> Records:
    with open(path, "rb") as f:
        data = f.read()
    headers, seqs = [], []
    for part in data.split(b">")[1:]:
        nl = part.find(b"\n")
        headers.append(">" + part[:nl].decode())
        seqs.append(part[nl + 1:].replace(b"\n", b""))
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    codes = _CODE[np.frombuffer(b"".join(seqs), dtype=np.uint8)]
    if (codes == 255).any():
        raise ValueError(f"{path}: the reference reads A, C, G and T only")
    return Records(headers, codes, offsets)


def histograms(rec: Records, k: int, datatype: str, device) -> torch.Tensor:
    """[N, 4^k] pseudocounted histograms saturated at 255, uint8 on
    `device` (the configurations' uint8_t)."""
    if datatype != "uint8_t":
        raise NotImplementedError(f"{datatype} histograms")
    n, d = len(rec.headers), 4 ** k
    codes = torch.as_tensor(rec.codes, device=device).to(torch.int64)
    lens = torch.as_tensor(rec.lengths, device=device)
    seq = torch.repeat_interleave(torch.arange(n, device=device), lens)
    starts = torch.as_tensor(rec.offsets[:-1], device=device)
    total = len(codes)
    out = torch.zeros(n * d, dtype=torch.int64, device=device)
    step = 1 << 24
    for s in range(0, max(total - k + 1, 0), step):
        e = min(total - k + 1, s + step)
        idx = torch.zeros(e - s, dtype=torch.int64, device=device)
        for j in range(k):
            idx = idx * 4 + codes[s + j:e + j]
        sid = seq[s:e]
        inside = torch.arange(s, e, device=device) - starts[sid] <= lens[sid] - k
        out += torch.bincount((sid * d + idx)[inside], minlength=n * d)
    return (out + 1).clamp_(max=255).view(n, d).to(torch.uint8)


def reference_order(rec: Records) -> np.ndarray:
    """Rows by header, then by length with std::sort's tie order."""
    by_header = np.array(sorted(range(len(rec.headers)),
                                key=lambda i: rec.headers[i].encode()),
                         dtype=np.int64)
    return by_header[sort_perm(rec.lengths[by_header])]
