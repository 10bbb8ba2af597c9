"""Semi-synthetic mutation engine.

Behavioral rebuild of the reference's HandleSeq / MultiMute / SingMute
(HandleSeq.cpp:76-137, MultiMute.cpp:15-475, SingMute.cpp:29-162): given a
template sequence and a target mutation percentage, applies block mutations
(translocate / reverse / delete / duplicate / insert) followed by point
mutations (switch / insert / delete) on the untouched positions, and returns
(identity_estimate, mutated_sequence) where

    identity = (len - multi.IBP - sing.IBP)
             / (len + multi.alignLen + sing.alignLen)        (HandleSeq.cpp:124-128)

All randomness flows through the MMIX LCG exactly as in the reference; block
placement quirks (mutation blocks concatenated after the S-run rather than
shuffled, reversions degenerating to deletions in formatString) are
preserved because they shape the training distribution.
"""
from __future__ import annotations

from typing import List, Tuple

from ..utils.rng import LCG, MinStd0, shuffle_libstdcxx

MUT_SINGLE = 1
MUT_NON_SINGLE = 2
MUT_BOTH = 3
MUT_TRANSLOCATION = 4
MUT_REVERSION = 8


class MultiMute:
    def __init__(self, pa: int, pc: int, pg: int, pt: int, alloc: int,
                 enable_trans: bool, enable_rev: bool, seed: int):
        self.rng = LCG(seed & 0xFFFFFFFF)
        self.percs = (pa, pc, pg, pt)
        self.max_trans = 0
        self.max_insert = 0
        self.max_reverse = 0
        self.max_dup = 0
        self.max_del = 0
        self.total_alloc = alloc
        self.alignment_length = 0
        self.ibp = 0
        if alloc == 0:
            return
        # percentage split among mutation kinds (MultiMute.cpp:30-71).
        # Note: alloc == 1 does NOT return early in the reference — it falls
        # through to the dup draw below, consuming one RNG value
        # (maxDup = randMod(1) == 0).
        if alloc == 1:
            self.max_insert = 1
        elif enable_trans:
            if alloc > 1:
                self.max_trans = self.rng.rand_mod(alloc)
                alloc -= self.max_trans
        elif enable_rev:
            if alloc > 1:
                self.max_reverse = self.rng.rand_mod(alloc)
                alloc -= self.max_reverse
        if alloc > 1:
            self.max_del = self.rng.rand_mod(alloc)
            alloc -= self.max_del
        if alloc > 0:
            self.max_dup = self.rng.rand_mod(alloc)
            alloc -= self.max_dup
        else:
            self.max_dup = 0
            if alloc == 1:
                alloc -= 1
                self.max_del += 1
        self.max_insert = alloc

    # -- block builders (MultiMute.cpp:172-296) -----------------------------

    def _blocks(self, budget: int, ch: str, use_cap: bool) -> List[str]:
        out = []
        while budget > 0:
            if budget <= 2:
                size = budget
            else:
                cap = min(self.max_block_size, budget - 2) if use_cap else budget - 2
                size = self.rng.rand_mod(cap) + 2
                if budget - size == 1:
                    size += 1
            out.append(ch * size)
            budget -= size
        return out

    def _gen_insert(self, size: int) -> str:
        pa, pc, pg, pt = self.percs
        total = pa + pc + pg + pt
        s = []
        for _ in range(size):
            v = self.rng.rand_mod(total)
            if v < pa:
                s.append("A")
            elif v < pa + pc:
                s.append("C")
            elif v < pa + pc + pg:
                s.append("G")
            else:
                s.append("T")
        return "".join(s)

    def gen_multi(self, seq: str) -> Tuple[str, List[bool]]:
        """Apply block mutations; returns (mutated_seq, validity_mask)
        (MultiMute.cpp:121-170)."""
        import numpy as np

        n = len(seq)
        mut_bp = self.total_alloc * n / 100.0
        self.max_block_size = max(2, min(50, int(round_half(mut_bp / 10))))
        # the reference scales percentages through float32:
        # (int64_t)((float)(pct / 100.0) * seq->length()) (MultiMute.cpp:128-133)
        def scale(pct):
            return int(np.float32(np.float32(pct / 100.0) * np.float32(n)))

        pct_total = (100 - self.max_reverse - self.max_trans - self.max_insert
                     - self.max_dup - self.max_del)
        max_non = scale(pct_total)
        self.max_reverse = scale(self.max_reverse)
        self.max_trans = scale(self.max_trans)
        self.max_insert = scale(self.max_insert)
        self.max_del = scale(self.max_del)
        self.max_dup = scale(self.max_dup)
        self.alignment_length = self.max_insert + self.max_dup
        self.ibp = self.max_del

        strings: List[str] = ["S"] * max_non
        # reverse blocks (budget consumed without the 50-cap, MultiMute.cpp:172-195)
        strings += self._blocks(self.max_reverse, "R", use_cap=False)
        # insert blocks: "I" markers + generated strings (MultiMute.cpp:221-248)
        self.insertions: List[str] = []
        budget = self.max_insert
        while budget > 0:
            if budget <= 2:
                size = budget
            else:
                size = self.rng.rand_mod(min(self.max_block_size, budget - 2)) + 2
                if budget - size == 1:
                    size += 1
            strings.append("I")
            self.insertions.append(self._gen_insert(size))
            budget -= size
        # translocate blocks: "T"*size then "I" (MultiMute.cpp:197-219)
        budget = self.max_trans
        while budget > 0:
            if budget <= 2:
                size = budget
            else:
                size = self.rng.rand_mod(min(self.max_block_size, budget - 2)) + 2
                if budget - size == 1:
                    size += 1
            strings.append("T" * size)
            strings.append("I")
            budget -= size
        strings += self._blocks(self.max_dup, "D", use_cap=True)
        strings += self._blocks(self.max_del, "X", use_cap=True)

        self._check_palindromes(seq, strings)
        chars = [c for s in strings for c in s]
        self._get_translocations(seq, chars)
        return self._format_string(seq, chars)

    def _check_palindromes(self, seq: str, strings: List[str]) -> None:
        """Replace palindromic reverse blocks with translocations
        (MultiMute.cpp:439-475)."""
        insertion_changes = 0
        i = 0
        j = 0
        while i < len(seq) and j < len(strings):
            s = strings[j]
            if s[0] != "R":
                if s[0] == "I":
                    j += 1
                else:
                    i += len(s)
                    j += 1
            else:
                if self._not_palindrome(seq, i, i + len(s) - 1):
                    i += len(s)
                    j += 1
                else:
                    strings[j] = "T" * len(s)
                    insertion_changes += 1
        for _ in range(insertion_changes):
            idx = self.rng.rand_mod(len(strings))
            strings.insert(idx, "I")

    @staticmethod
    def _not_palindrome(seq: str, start: int, end: int) -> bool:
        while start < end:
            if seq[start] != seq[end]:
                return True
            start += 1
            end -= 1
        return False

    def _get_translocations(self, seq: str, chars: List[str]) -> None:
        """Copy T-run source characters into the insertion pool
        (MultiMute.cpp:401-422)."""
        i = 0
        j = 0
        n = len(seq)
        while i < n and j < len(chars):
            if chars[j] == "T":
                tmp = []
                while j < len(chars) and chars[j] == "T" and i < n:
                    tmp.append(seq[i])
                    i += 1
                    j += 1
                self.insertions.append("".join(tmp))
            elif chars[j] == "I":
                j += 1
            else:
                j += 1
                i += 1

    def _format_string(self, seq: str, chars: List[str]) -> Tuple[str, List[bool]]:
        """(MultiMute.cpp:331-398) — S copies, I inserts from the shuffled
        pool, D duplicates, everything else (R/T/X) drops the position."""
        shuffle_libstdcxx(self.insertions, MinStd0(0))
        out: List[str] = []
        valid: List[bool] = []
        i = 0
        j = 0
        n = len(seq)
        while i < n and j < len(chars):
            c = chars[j]
            if c == "S":
                out.append(seq[i])
                valid.append(True)
                i += 1
                j += 1
            elif c == "I":
                if self.insertions:
                    ins = self.insertions.pop()
                    out.append(ins)
                    valid.extend([False] * len(ins))
                j += 1
            elif c == "D":
                dup = []
                while j < len(chars) and chars[j] == "D" and i < n:
                    dup.append(seq[i])
                    out.append(seq[i])
                    valid.append(False)
                    valid.append(False)
                    i += 1
                    j += 1
                out.append("".join(dup))
            else:
                i += 1
                j += 1
        if self.insertions:
            for ins in self.insertions:
                out.append(ins)  # reference appends without validity flags
            self.insertions = []
        return "".join(out), valid


class SingMute:
    def __init__(self, pa: int, pc: int, pg: int, pt: int, num_mut: int,
                 seq: str, valid: List[bool], seed: int):
        self.rng = LCG(seed & 0xFFFFFFFF)
        self.percs = (pa, pc, pg, pt)
        self.alignment_length = 0
        self.ibp = 0
        self.out_seq = seq
        self._init(num_mut, seq, valid)

    def _rand_nucl(self) -> str:
        pa, pc, pg, pt = self.percs
        v = self.rng.rand_mod(pa + pc + pg + pt)
        if v < pa:
            return "A"
        if v < pa + pc:
            return "C"
        if v < pa + pc + pg:
            return "G"
        return "T"

    def _init(self, num_mut: int, seq: str, valid: List[bool]) -> None:
        max_insert = max_del = max_switch = 0
        if num_mut == 0:
            self.out_seq = seq
            return
        elif num_mut == 1:
            max_insert = 1
        else:
            max_switch = self.rng.rand_mod(num_mut)
            num_mut -= max_switch
            if max_switch % 2 == 1 and num_mut >= 1:
                max_switch += 1
                num_mut -= 1
            elif num_mut == 0:
                max_switch -= 1
                num_mut += 1
            if num_mut > 1:
                max_insert = self.rng.rand_mod(num_mut)
                num_mut -= max_insert
            else:
                max_insert = num_mut
                num_mut = 0
            max_del = num_mut
        n = len(seq)
        max_del = int(max_del * (n / 100.0))
        max_insert = int(max_insert * (n / 100.0))
        max_switch = int(max_switch * (n / 100.0))
        self.alignment_length = max_insert
        self.ibp = max_del + max_switch

        cmd = ["S"] * n
        idx = 0
        nons_len = max_insert + max_del + max_switch
        for _ in range(max_insert):
            cmd[idx] = "I"; idx += 1
        for _ in range(max_del):
            cmd[idx] = "D"; idx += 1
        for _ in range(max_switch):
            cmd[idx] = "W"; idx += 1
        shuffle_libstdcxx(cmd, MinStd0(self.rng.next_rand_seed()))
        # repair: move mutations off invalid (already block-mutated) positions
        # (SingMute.cpp:102-123)
        valid_indices: List[int] = []
        repl = n - 1
        for i in range(n):
            if cmd[i] != "S" and not valid[i]:
                if valid_indices:
                    repl = valid_indices.pop()
                else:
                    while repl > 0 and not valid[repl]:
                        repl -= 1
                cmd[i], cmd[repl] = cmd[repl], cmd[i]
            elif cmd[i] == "S" and valid[i] and len(valid_indices) < nons_len:
                valid_indices.append(i)
        out: List[str] = []
        for i in range(n):
            c = cmd[i]
            if c == "I":
                out.append(self._rand_nucl())
                out.append(seq[i])
            elif c == "S":
                out.append(seq[i])
            elif c == "W":
                out.append(self._rand_nucl())
            # 'D': drop
        self.out_seq = "".join(out)


def round_half(x: float) -> int:
    """C round(): half away from zero."""
    import math

    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


class HandleSeq:
    def __init__(self, mode: int, seed: int):
        self.mode = mode & MUT_BOTH
        self.enable_trans = bool(mode & MUT_TRANSLOCATION)
        self.enable_rev = bool(mode & MUT_REVERSION)
        # the reference's seed parameters are std::random_device::result_type
        # (32-bit), truncating the 64-bit LCG draws at every constructor
        # boundary (HandleSeq.h:44, MultiMute.h, SingMute.h)
        self.random = LCG(seed & 0xFFFFFFFF)

    def mutate(self, sequence: str, mute_rate: int, split: int) -> Tuple[float, str]:
        if mute_rate == 0:
            return 1.0, sequence
        n = len(sequence)
        counts = [sequence.count(c) for c in "ACGT"]
        pa, pc, pg, pt = (c * 100 // n for c in counts)
        if self.mode == MUT_SINGLE:
            perc_multi, perc_sing = 0, mute_rate
        elif self.mode == MUT_NON_SINGLE:
            perc_multi, perc_sing = mute_rate, 0
        else:
            perc_multi = split
            perc_sing = mute_rate - split
        multi = MultiMute(pa, pc, pg, pt, perc_multi,
                          self.enable_trans, self.enable_rev,
                          self.random.next_rand_seed())
        mut_seq, valid = multi.gen_multi(sequence)
        if len(valid) != len(mut_seq):
            raise RuntimeError("mutation size is not matching the multi-sequence")
        sing = SingMute(pa, pc, pg, pt, perc_sing, mut_seq, valid,
                        self.random.next_rand_seed())
        # float32 arithmetic like the reference's `float` identity
        # (HandleSeq.cpp:124-128)
        import numpy as np

        alignment_length = np.float32(
            multi.alignment_length + sing.alignment_length + n
        )
        ibp = np.float32(n - multi.ibp - sing.ibp)
        identity = float(np.float32(ibp / alignment_length))
        return identity, sing.out_seq
