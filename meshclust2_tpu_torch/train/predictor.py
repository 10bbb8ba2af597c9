"""Training driver: semi-synthetic pair generation + GLM selection.

Rebuild of Predictor<T>::train (Predictor.cpp:518-710,875-985):

  1. pick templates by uniform stride over the length-sorted points;
  2. calibrate positive/negative sample counts from 45 probe mutations of
     the first template (Predictor.cpp:560-634);
  3. per template, generate positive ([100*id, 100]) and negative
     ([min_id, 100*id]) mutants with the block/point mutation engine and
     histogram them;
  4. balance by |identity - id| sort + uniform downsample to
     (n, 2n) pos/neg (Predictor.cpp:649-666);
  5. select feature-pair sets by best-first search on GLM test accuracy and
     solve the final weights (train/selectors.py).

Pair feature tables are computed in one batched pass instead of the
reference's per-pair memo cache.

The port's copy of meshclust2_tpu/train/predictor.py.  The pair tables
come from the card (train/device_tables.py), as in the JAX package under
--device tpu; the selection runs on them, and the shipped weights are
re-solved on the host's exact float64 columns.  A feature set with singles
the pair statistics do not derive (`--feat slow` and `extraslow`:
device_tables.stats_refusal), and a population that the kernels do not
take (device_store.store_refusal), get the host oracle's table instead,
with one stderr line, as under the JAX package's --device host.
"""
from __future__ import annotations

import math
import sys
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..features import flags as F
from ..features import host as H
from ..io.fasta import codes_to_acgt
from ..kmer.counting import PointSet, build_point_set, _record_from_codes
from ..model.weights import ModelBlock, PredictorModel, PRED_MODE_CLASS, PRED_MODE_REGR
from ..mutate.engine import HandleSeq
from ..utils.rng import LCG, MTRandom
from ..cluster.device_store import store_refusal
from . import selectors as S
from .device_tables import TableStats, device_raw_singles, stats_refusal


def c_round(x: float) -> int:
    return int(math.floor(x + 0.5)) if x >= 0 else int(math.ceil(x - 0.5))


def identities_for_gen(id_begin: float, id_end: float, num_seq: int, rnd: LCG) -> List[int]:
    """(Predictor.cpp:187-197)"""
    out = []
    inc = (id_end - id_begin) / num_seq
    for i in range(num_seq):
        iter_id = id_begin + inc * (i + 0.5)
        actual = rnd.rand_between(iter_id, inc, id_begin, id_end)
        mut = c_round(100 - actual)
        out.append(1 if mut == 0 else mut)
    return out


def _template_seq(ps: PointSet, row: int) -> str:
    codes = ps.seqs[row]
    return codes_to_acgt(codes)


def mutate_seqs(
    ps: PointSet,
    row: int,
    num_seq: int,
    id_begin: float,
    id_end: float,
    mut_type: int,
    seed: int,
) -> List[Tuple[int, str, float]]:
    """One template's mutants (Predictor.cpp:754-811): returns
    (template_row, mutated_sequence, identity) triples."""
    rnd = LCG(seed)
    h = HandleSeq(mut_type, rnd.next_rand_seed())
    seq = _template_seq(ps, row)
    out = []
    inc = (id_end - id_begin) / num_seq
    for i in range(num_seq):
        iter_id = id_begin + inc * (i + 0.5)
        actual = rnd.rand_between(iter_id, inc, id_begin, id_end)
        mut = c_round(100 - actual)
        mut = 1 if mut == 0 else mut
        spt = rnd.rand_mod(mut)
        val, newseq = h.mutate(seq, mut, spt)
        out.append((row, newseq, val))
    return out


def remove_uniform(items: List, trim_size: int) -> List:
    """Uniform-stride downsample keeping ~trim_size items
    (Predictor.cpp:422-441)."""
    n = len(items)
    # trim_size 0 gives inc=+inf in the reference (IEEE n/0.0), keeping only
    # item 0 — preserve that rather than keeping everything
    inc = n / trim_size if trim_size > 0 else math.inf
    if inc <= 1:
        inc = 1.0
    out = []
    i_keep = 0.0
    for i in range(n):
        if i == c_round(i_keep):
            out.append(items[i])
            i_keep += inc
    return out


def _build_pair_tables(
    ps: PointSet,
    pairs: List[Tuple[int, "object", float]],
    mutant_ps: PointSet,
    singles: List[int],
    id_cutoff: float,
    device,
    mins=None,
    maxs=None,
    table_stats: Optional[TableStats] = None,
):
    """Raw + normalized singles for (template, mutant) pairs, built on the
    card with exact extrema; bounds computed from this population when not
    supplied (calculate_table semantics: normalize over training only,
    BestFirstSelector.cpp:112-128).  Returns (table, mins, maxs,
    make_exact)."""
    t_rows = np.array([p[0] for p in pairs], dtype=np.int64)
    m_rows = np.arange(len(pairs), dtype=np.int64)
    # the host oracle: reference-accumulation-order raw values over a
    # combined point set (templates + mutants), required for byte-exact
    # weights
    from ..kmer.counting import concat_point_sets
    from ..native import raw_singles_batch

    combined = concat_point_sets([ps, mutant_ps])

    def _host_exact(idx):
        sub = raw_singles_batch(combined, t_rows[idx], ps.n + m_rows[idx],
                                singles)
        if sub is None:
            A = H.side_from_pointset(ps, t_rows[idx])
            B = H.side_from_pointset(mutant_ps, m_rows[idx])
            sub = H.compute_singles(singles, A, B)
        return sub

    why = stats_refusal(singles) or store_refusal(combined)
    if why is not None:
        # a population the kernels do not take: the host oracle's table,
        # which is already exact (the JAX CLI's --device host build)
        print(f"meshclust2-torch: {why}: training tables on the host",
              file=sys.stderr)
        raw = _host_exact(np.arange(len(pairs)))
    else:
        # P4 on the card (Predictor.cpp:344): the pair-statistics kernel and
        # the float64 epilogue, with exact-extrema rechecks so normalization
        # bounds stay bit-identical to the host build
        raw = device_raw_singles(combined, t_rows, ps.n + m_rows, singles,
                                 _host_exact, device, table_stats)
    if mins is None:
        mins, maxs = S.normalize_bounds(raw, singles)
    normalized = S.apply_normalization(raw, singles, mins, maxs)
    vals = np.array([p[2] for p in pairs])
    labels = np.where(vals >= id_cutoff, 1.0, -1.0)
    tbl = S.SinglesTable(singles=singles, raw=raw, normalized=normalized,
                         labels=labels, values=vals)
    exact_cache: List[S.SinglesTable] = []

    def make_exact(mins=mins, maxs=maxs, labels=labels, vals=vals):
        """Float64-oracle rebuild of this table (same bounds — they are
        already exact by the recheck contract): the device table's entry
        error is amplified ~kappa^2 by the normal-equations solve, so the
        FINAL weights are re-solved on exact columns after selection.
        Memoized: classification and regression chains both re-solve."""
        if not exact_cache:
            ex = _host_exact(np.arange(len(pairs)))
            exact_cache.append(S.SinglesTable(
                singles=singles, raw=ex,
                normalized=S.apply_normalization(ex, singles, mins, maxs),
                labels=labels, values=vals))
        return exact_cache[0]

    return tbl, mins, maxs, make_exact


def _gen_balanced(
    ps: PointSet,
    template_rows: List[int],
    seeds: List[int],
    n_pos: int,
    n_neg: int,
    identity: float,
    min_id_pct: float,
    mut_type: int,
    label: str = "Generating data",
    kind: str = "training",
    verbose: bool = True,
) -> List[Tuple[int, str, float]]:
    """Generate, split, sort and downsample one population
    (Predictor.cpp:636-699)."""
    from ..utils.progress import Progress

    pos_buf: List[Tuple[int, str, float]] = []
    neg_buf: List[Tuple[int, str, float]] = []
    prog = Progress(len(template_rows), label)  # Predictor.cpp:636,673
    for row, seed in zip(template_rows, seeds):
        prog.step()
        gen = mutate_seqs(ps, row, n_pos, 100 * identity, 100, mut_type, seed)
        gen += mutate_seqs(ps, row, n_neg, min_id_pct, 100 * identity, mut_type, seed)
        tmpl_len = int(ps.lengths[row])
        # uint64-truncated window bounds (Predictor.cpp:501-505)
        min_len = int(tmpl_len * identity)
        max_len = int(tmpl_len / identity)
        for row_, seq_, val_ in gen:
            if val_ > identity:
                # length sanity check on the mutant's effective size
                # (Predictor.cpp:496-517)
                second_len = _effective_len(seq_)
                if min_len <= second_len <= max_len:
                    pos_buf.append((row_, seq_, val_))
            else:
                neg_buf.append((row_, seq_, val_))
    buf_size = min(len(pos_buf), len(neg_buf))
    if verbose:
        # Predictor.cpp:647-648,684-685
        print(f"{kind} +: {len(pos_buf)}")
        print(f"{kind} -: {len(neg_buf)}")
    from ..native import sort_perm

    def sort_by_dist(buf):
        keys = np.array([abs(t[2] - identity) for t in buf])
        return [buf[j] for j in sort_perm(keys)]

    pos_buf = sort_by_dist(pos_buf)
    neg_buf = sort_by_dist(neg_buf)
    kept_pos = remove_uniform(pos_buf, buf_size)
    kept_neg = remove_uniform(neg_buf, 2 * buf_size)
    kept = kept_pos + kept_neg
    prog.end()
    if verbose:
        # Predictor.cpp:666,699 (remove_uniform returns the ACTUAL kept count)
        print(f"{kind.capitalize()} final #: +: {len(kept_pos)} -: {len(kept_neg)}")
    return kept


def _effective_len(seq: str) -> int:
    n = len(seq)
    return n if n > 1 else 0


def _mutant_point_set(pairs: List[Tuple[int, str, float]], k: int, datatype: str,
                      count_device=None) -> PointSet:
    recs = []
    for _, seq, _ in pairs:
        arr = np.frombuffer(seq.encode(), dtype=np.uint8)
        lut = np.full(256, -1, dtype=np.int8)
        for ch, code in zip(b"ACGT", range(4)):
            lut[ch] = code
        codes = lut[arr]
        recs.append(_record_from_codes(">mut", codes))
    return build_point_set(recs, k, datatype, count_device=count_device)


def train_predictor(
    ps: PointSet,
    k: int,
    identity: float,
    datatype: str,
    feat_flags: int,
    mut_type: int,
    min_feat: int = 4,
    max_feat: int = 4,
    min_id: float = 0.35,
    n_samples: int = 2000,
    n_templates: int = 300,
    mode: int = PRED_MODE_CLASS,
    clock=None,
    rng: Optional[MTRandom] = None,
    verbose: bool = True,
    device="cuda",
    table_stats: Optional[TableStats] = None,
) -> PredictorModel:
    """Predictor<T>::train; the pair tables are built on `device` (a CUDA
    device runs the kernels, the CPU their plain versions), and
    `table_stats` gathers what their builder did."""
    rng = rng or MTRandom(0xAA)
    n = ps.n
    min_id_pct = min_id * 100.0
    num_templates = min(n_templates, n)
    f_tr = [int(i * n / (2 * num_templates)) for i in range(num_templates)]
    f_te = [int((i + 1) * n / (2 * num_templates)) for i in range(num_templates)]
    if verbose:
        print(f"params: total_samples: {n_samples} num_templates: {num_templates}")
        # Predictor.cpp:536
        print(f"# of templates: {num_templates} train: {len(f_tr)} test: {len(f_te)}")
    pts_per_mut = n_samples / num_templates

    train_seeds = [rng.next_rand_seed() for _ in f_tr]
    test_seeds = [rng.next_rand_seed() for _ in f_te]

    n_pos = n_neg = 10
    if mode & PRED_MODE_CLASS:
        # calibration from 45 probe mutations of template 0
        # (Predictor.cpp:560-634)
        if verbose:
            print("mutating sequences")  # Predictor.cpp:559
        seed = rng.next_rand_seed()
        rnd = LCG(seed)
        mut_rates = identities_for_gen(100 * identity, 100, 15, rnd)
        mut_rates += identities_for_gen(min_id_pct, 100 * identity, 30, rnd)
        seq0 = _template_seq(ps, f_tr[0])
        P = N = 0.0
        for mut_rate in mut_rates:
            hs = HandleSeq(mut_type, seed)
            lcg = LCG(seed)
            spt = lcg.rand_mod(mut_rate)
            val, _ = hs.mutate(seq0, mut_rate, spt)
            if val > identity:
                P += 1
            else:
                N += 1
        if verbose:
            # Predictor.cpp:614 (note the double space from `" / " << " P: "`)
            print(f"pts_per_mut: {pts_per_mut:.6g} /  P: {P:.6g} N: {N:.6g}")
        P = max(1.0, P)
        N = max(1.0, N)
        nd_pos = pts_per_mut / (1 + 4 * P / N)
        nd_neg = pts_per_mut / (1 + N / (P * 4))
        n_pos = math.ceil(nd_pos)
        n_neg = math.ceil(nd_neg)
        if verbose:
            # Predictor.cpp:630-631
            print(f"found: {int(P)}, {int(N)} -> {nd_pos:.6g}, {nd_neg:.6g} "
                  f"-> {n_pos}, {n_neg}")
            print(f"final +: {n_pos} -: {n_neg}")

    if mode & PRED_MODE_CLASS:
        training = _gen_balanced(ps, f_tr, train_seeds, n_pos, n_neg, identity,
                                 min_id_pct, mut_type,
                                 label="Generating training", kind="training",
                                 verbose=verbose)
        testing = _gen_balanced(ps, f_te, test_seeds, n_pos, n_neg, identity,
                                min_id_pct, mut_type,
                                label="Generating testing", kind="testing",
                                verbose=verbose)
    else:
        # regression-only data generation: 5 mutants per template over
        # [min_id, 100] (Predictor.cpp:701-708)
        training = []
        for row, seed in zip(f_tr, train_seeds):
            training += mutate_seqs(ps, row, 5, min_id_pct, 100, mut_type, seed)
        testing = []
        for row, seed in zip(f_te, test_seeds):
            testing += mutate_seqs(ps, row, 5, min_id_pct, 100, mut_type, seed)
    if clock is not None:
        clock.stamp("data_generation")

    singles = F.split_flags(feat_flags)
    train_mut_ps = _mutant_point_set(training, k, datatype, device)
    test_mut_ps = _mutant_point_set(testing, k, datatype, device)
    # device tables serve every mode: the regression chain's RNG-consuming
    # row rebalance depends only on pair identity values (host-exact), so
    # its selection replays verbatim onto the float64 re-solve tables
    tr_tbl, mins, maxs, tr_exact = _build_pair_tables(
        ps, training, train_mut_ps, singles, identity, device,
        table_stats=table_stats)
    te_tbl, _, _, te_exact = _build_pair_tables(
        ps, testing, test_mut_ps, singles, identity, device, mins, maxs,
        table_stats=table_stats)

    possible = S.enumerate_feat_pairs(feat_flags)
    model = PredictorModel(
        k=k,
        mode=mode,
        max_features=max_feat,
        id_cutoff=identity,
        datatype=datatype,
        feature_set=feat_flags,
    )
    if mode & PRED_MODE_CLASS:
        feat_set, weights, _, _ = S.best_first_select(
            tr_tbl, te_tbl, possible, min_feat, max_feat, verbose=verbose
        )
        # device tables drove the selection; the shipped weights come from
        # one exact re-solve on the float64-oracle columns
        _, weights, _, _ = S.class_eval(tr_exact(), te_exact(), feat_set)
        model.classifier = _to_block(feat_set, weights, singles, mins, maxs)
    if mode & PRED_MODE_REGR:
        trr, ter = tr_tbl, te_tbl
        sel_tr = sel_te = None
        if mode & PRED_MODE_CLASS:
            sel_tr = _regression_filter_sel(tr_tbl.values, identity, rng)
            sel_te = _regression_filter_sel(te_tbl.values, identity, rng)
            trr, ter = _subset_tbl(tr_tbl, sel_tr), _subset_tbl(te_tbl, sel_te)
        feat_set, weights = S.greedy_select_regression(trr, ter, possible, max_feat,
                                                       verbose=verbose)
        # device tables drove the greedy selection; the shipped regression
        # weights come from one exact float64 re-solve on the same
        # (replayed) row selection
        from ..glm.exact import train_glm_exact

        tr_ex = tr_exact()
        if sel_tr is not None:
            tr_ex = _subset_tbl(tr_ex, sel_tr)
        weights = train_glm_exact(
            S.design_matrix(tr_ex, feat_set), tr_ex.values)
        model.regressor = _to_block(feat_set, weights, singles, mins, maxs)
    if verbose:
        # Predictor.cpp:938-947 (sizes after selection, then a blank line)
        print(f"Training size: {len(training)}")
        print(f"Testing size: {len(testing)}")
        print()
    if clock is not None:
        clock.stamp("GLM")
    return model


def _to_block(feat_set, weights, all_singles, all_mins, all_maxs) -> ModelBlock:
    """Reduce to the singles actually used, in add_feature insertion order
    over the sorted feature set (load_feat, BestFirstSelector.cpp:78-110)."""
    used: List[int] = []
    for flags_, _ in feat_set:
        for s in F.split_flags(flags_):
            if s not in used:
                used.append(s)
    mins = np.array([all_mins[all_singles.index(s)] for s in used])
    maxs = np.array([all_maxs[all_singles.index(s)] for s in used])
    return ModelBlock(
        combos=[(kind, flags_) for flags_, kind in feat_set],
        weights=np.asarray(weights),
        singles=used,
        mins=mins,
        maxs=maxs,
    )


def _regression_filter_sel(values: np.ndarray, identity: float,
                           rng: MTRandom) -> np.ndarray:
    """Row selection of the regression rebalance (Predictor.cpp:714-751,
    925-932): drop val<=id pairs and rebalance into 10 equal identity
    bins.  Depends only on the pair identity VALUES (host-exact, from the
    mutation engine) and the RNG — never on the feature columns — so the
    same selection replays verbatim onto a float64-oracle rebuild of a
    device-computed table."""
    keep = values > identity
    idx = np.nonzero(keep)[0]
    num_bins = 10
    limits = [identity + i * (1 - identity) / num_bins for i in range(num_bins)] + [1.0]
    bins = [[] for _ in range(num_bins)]
    for i in idx:
        v = values[i]
        for b in range(1, len(limits)):
            if limits[b - 1] < v <= limits[b]:
                bins[b - 1].append(i)
                break
    total = sum(len(b) for b in bins)
    smallest = total // num_bins if num_bins else 0
    sel: List[int] = []
    for b in bins:
        bb = list(b)
        rng.shuffle(bb)
        sel.extend(bb[: min(len(bb), smallest)])
    return np.array(sel, dtype=np.int64)


def _subset_tbl(tbl: S.SinglesTable, sel: np.ndarray) -> S.SinglesTable:
    return S.SinglesTable(
        singles=tbl.singles,
        raw=tbl.raw[sel],
        normalized=tbl.normalized[sel],
        labels=tbl.labels[sel],
        values=tbl.values[sel],
    )
