"""The port's Red (meshclust2_tpu_torch/red/) against the JAX package's Red
on the same inputs.  Red is host code in both packages (numpy and the native
library's Red helpers), so every comparison is exact: the committed
reference binary's .scr/.rpt of the fixture genome; every output file
(.scr, .rpt in both formats, .msk, .cnd, -tbl, -hmo) and stdout byte for
byte on the fixture and on seeded synthetic genomes (tests/red_genome.py,
two files, planted repeat families, runs of N, soft-masked stretches) at
the default k and at -len 8, with a -dir scan; the error paths' exit codes
and messages; each native binding against its numpy fallback (the library
forced off by MC2_NO_NATIVE, as in the JAX package) and the JAX binding."""
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest

from meshclust2_tpu_torch.io.fasta import encode_sequence
from meshclust2_tpu_torch import native as torch_native
from meshclust2_tpu_torch.red import cli as torch_red
from meshclust2_tpu_torch.red.detector import DetectorMaxima, detect_chrom
from meshclust2_tpu_torch.red.hmm import HMM
from meshclust2_tpu_torch.red.scorer import ChromScores
from meshclust2_tpu_torch.red.table import EnrichmentTable, _word_counts, c_round

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from red_genome import write_genome  # noqa: E402

OUTPUTS = ["-rpt", "-msk", "-sco", "-cnd"]


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """~200 kbp in six records over two files; few families, so each has
    copies enough for Red to find at the default k."""
    d = tmp_path_factory.mktemp("genome")
    write_genome(str(d), seed=11, total_bp=200_000, n_records=6, n_files=2,
                 n_families=4, repeat_share=0.12)
    return str(d)


def run_both(capsys, tmp_path, args, outputs=OUTPUTS, tbl=False, hmo=True):
    """Run the JAX Red, then the port's, each writing into its own folder;
    returns both folders, exit codes and captured (stdout, stderr)."""
    from meshclust2_tpu.red import cli as jax_red

    got = {}
    for name, main in (("jax", jax_red.main), ("port", torch_red.main)):
        out = tmp_path / name
        out.mkdir()
        argv = list(args)
        for flag in outputs:
            argv += [flag, str(out)]
        if tbl:
            argv += ["-tbl", str(out / "table.tbl")]
        if hmo:
            argv += ["-hmo", str(out / "model.hmm")]
        capsys.readouterr()
        rc = main(argv)
        got[name] = (out, rc, capsys.readouterr())
    return got


def assert_same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    assert names
    for name in names:
        with open(os.path.join(a, name), "rb") as f, \
                open(os.path.join(b, name), "rb") as g:
            assert f.read() == g.read(), name


CASES = {
    # name: (genome, extra flags, -tbl, scan dir)
    "fixture_len8": ("fixture", ["-len", "8"], True, None),
    "fixture_len8_bed": ("fixture", ["-len", "8", "-frm", "2"], False, None),
    "synthetic_default_k": ("synthetic", [], False, None),
    "synthetic_len8": ("synthetic", ["-len", "8"], True, None),
    "synthetic_len8_bed_dir": ("synthetic", ["-len", "8", "-frm", "2"], False,
                               "fixture"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_red_outputs_equal_the_jax_red(case, fixtures_dir, synthetic, capsys,
                                       tmp_path):
    genome, flags, tbl, scan = CASES[case]
    dirs = {"fixture": os.path.join(fixtures_dir, "red_genome"),
            "synthetic": synthetic}
    args = ["-gnm", dirs[genome], *flags]
    if scan:
        args += ["-dir", dirs[scan]]
    got = run_both(capsys, tmp_path, args, tbl=tbl)
    (jdir, jrc, jcap), (pdir, prc, pcap) = got["jax"], got["port"]
    assert jrc == prc == 0
    assert pcap.out == jcap.out and pcap.err == jcap.err
    assert_same_files(jdir, pdir)
    if scan:
        assert (pdir / "chr1.scr").exists()    # the -dir file was scanned
    if genome == "fixture":
        with open(os.path.join(fixtures_dir, "red_ref_chr1.scr"), "rb") as f:
            assert (pdir / "chr1.scr").read_bytes() == f.read()
    if genome == "fixture" and "-frm" not in flags:
        with open(os.path.join(fixtures_dir, "red_ref_chr1.rpt"), "rb") as f:
            assert (pdir / "chr1.rpt").read_bytes() == f.read()


def test_red_numpy_fallbacks_give_the_reference(fixtures_dir, capsys, tmp_path,
                                                monkeypatch):
    """The whole port Red with the native library forced off (every numpy
    fallback: word counts, chain, per-base scores, derivatives, Viterbi)
    writes the JAX native route's files and the reference's .scr/.rpt."""
    from meshclust2_tpu.red import cli as jax_red

    args = ["-gnm", os.path.join(fixtures_dir, "red_genome"), "-len", "8"]
    out = {}
    for name, main in (("jax", jax_red.main), ("port", torch_red.main)):
        if name == "port":
            monkeypatch.setenv("MC2_NO_NATIVE", "1")
        d = tmp_path / name
        d.mkdir()
        argv = args + [x for flag in OUTPUTS for x in (flag, str(d))]
        assert main(argv + ["-hmo", str(d / "model.hmm")]) == 0
        out[name] = d
    assert_same_files(out["jax"], out["port"])
    for ext in ("scr", "rpt"):
        with open(os.path.join(fixtures_dir, f"red_ref_chr1.{ext}"), "rb") as f:
            assert (out["port"] / f"chr1.{ext}").read_bytes() == f.read()


def error_args(kind, fixtures_dir, tmp_path):
    hmo = tmp_path / "model.hmm"
    hmm = HMM(2.0, 8)
    hmm.train(np.array([0] * 50 + [3] * 30 + [0] * 50), [(0, 129)], [(50, 79)])
    hmm.normalize()
    hmm.write(str(hmo))
    fa = os.path.join(fixtures_dir, "red_genome", "chr1.fa")
    empty = tmp_path / "empty"
    empty.mkdir()
    all_n = tmp_path / "all_n"
    all_n.mkdir()
    (all_n / "n.fa").write_text(">n\n" + "N" * 500 + "\n")
    return {
        "no_args": [],
        "odd_args": ["-gnm"],
        "invalid_flag": ["-foo", "x"],
        "no_mode": ["-len", "8"],
        "hmi_without_seq": ["-hmi", str(hmo)],
        "hmi_without_sci": ["-hmi", str(hmo), "-seq", fa],
        "hmi_scan_disabled": ["-hmi", str(hmo), "-seq", fa, "-sci", "x"],
        "empty_genome_dir": ["-gnm", str(empty)],
        "all_n_genome": ["-gnm", str(all_n), "-len", "8"],
        "nothing_scored": ["-gnm", os.path.join(fixtures_dir, "red_genome"),
                           "-len", "8", "-min", "100000000"],
    }[kind]


@pytest.mark.parametrize("kind", ["no_args", "odd_args", "invalid_flag", "no_mode",
                                  "hmi_without_seq", "hmi_without_sci",
                                  "hmi_scan_disabled", "empty_genome_dir",
                                  "all_n_genome", "nothing_scored"])
def test_red_error_paths_equal_the_jax_red(kind, fixtures_dir, capsys, tmp_path):
    args = error_args(kind, fixtures_dir, tmp_path)
    got = run_both(capsys, tmp_path, args, outputs=[], hmo=False)
    (_, jrc, jcap), (_, prc, pcap) = got["jax"], got["port"]
    assert jrc == prc == 1
    assert pcap.err == jcap.err and pcap.err
    assert pcap.out == jcap.out


def test_red_entry_exits_with_main_code(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["red-torch", "-foo", "x"])
    with pytest.raises(SystemExit) as exc:
        torch_red._entry()
    assert exc.value.code == 1
    assert "Invalid argument: -foo" in capsys.readouterr().err


# -- each native binding: native == numpy fallback == the JAX binding -------

def seeded_record(seed, n=6000):
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)].copy()
    for at, size in ((700, 40), (2500, 3), (4100, 900), (n - 5, 5)):
        seq[at:at + size] = ord("N")
    return encode_sequence(">r", seq.tobytes().decode())


def random_hmm(seed, P):
    rng = np.random.default_rng(seed)
    hmm = HMM(2.0, 2 * P)
    hmm.p_counts = rng.integers(1, 50, 2 * P).astype(np.float64)
    hmm.t_counts = rng.integers(1, 50, (2 * P, 2 * P)).astype(np.float64)
    hmm.normalize()
    return hmm


def native_and_fallback(monkeypatch, fn):
    """fn() with the native library, then with it forced off."""
    nat = fn()
    monkeypatch.setenv("MC2_NO_NATIVE", "1")
    try:
        return nat, fn()
    finally:
        monkeypatch.delenv("MC2_NO_NATIVE")


def binding_case(name, seed, monkeypatch):
    """(native, numpy fallback, JAX binding) of one binding on seeded
    inputs."""
    from meshclust2_tpu import native as jax_native
    from meshclust2_tpu.red import detector as jax_det
    from meshclust2_tpu.red import hmm as jax_hmm
    from meshclust2_tpu.red import scorer as jax_scorer
    from meshclust2_tpu.red import table as jax_table

    rng = np.random.default_rng(seed)
    if name == "chain":
        k, order = (6, 2) if seed % 2 else (8, 3)
        observed = rng.integers(0, 60, 4**k).astype(np.int64)
        probs = []
        for m in range(order + 1):
            g = rng.integers(0, 90, (4**m, 4)).astype(np.float64)
            if m:
                g[0] = 0   # an empty group: NaN conditionals, as a table gets
            with np.errstate(invalid="ignore", divide="ignore"):
                probs.append(c_round(1e4 * g / g.sum(axis=1, keepdims=True))
                             .reshape(-1) / 1e4)
        l = float(rng.integers(4**k // 8, 4**k))
        return (torch_native.red_chain_scores(observed, probs, k, order, l, 3),
                EnrichmentTable._chain_scores_numpy(observed, probs, k, order, l, 3),
                jax_native.red_chain_scores(observed, probs, k, order, l, 3))
    if name == "word_counts":
        recs = [seeded_record(seed), seeded_record(seed + 1, 3000)]
        nat, fb = native_and_fallback(monkeypatch, lambda: _word_counts(recs, 7))
        return nat, fb, jax_table._word_counts(recs, 7)
    if name == "score_bases":
        rec = seeded_record(seed)
        table = SimpleNamespace(k=9, scores=rng.integers(0, 40, 4**9))
        nat, fb = native_and_fallback(monkeypatch,
                                      lambda: ChromScores(rec, table).scores)
        return nat, fb, jax_scorer.ChromScores(rec, table).scores
    if name == "derivatives":
        scores = rng.normal(1.5, 2.0, 5000).cumsum() % 7
        det = SimpleNamespace(w=10)
        nat, fb = native_and_fallback(
            monkeypatch, lambda: DetectorMaxima._derivatives(det, scores))
        return (np.stack(nat), np.stack(fb),
                np.stack(jax_det.DetectorMaxima._derivatives(det, scores)))
    if name == "viterbi":
        P = 6
        hmm = random_hmm(seed, P)
        seg = rng.integers(0, P, 4000).astype(np.int64)
        return (torch_native.viterbi_two_track(seg, hmm.p_log, hmm.t_log, P),
                hmm._decode_numpy(seg, P, hmm.t_log),
                jax_native.viterbi_two_track(seg, hmm.p_log, hmm.t_log, P))
    if name == "decode_segment":
        P = 5
        hmm = random_hmm(seed, P)
        scores = np.repeat(rng.integers(0, P, 500), rng.integers(1, 30, 500))
        jhmm = jax_hmm.HMM(2.0, 2 * P)
        jhmm.p_log, jhmm.t_log = hmm.p_log, hmm.t_log
        nat, fb = native_and_fallback(
            monkeypatch, lambda: hmm.decode_segment(scores, 17, len(scores) - 9))
        return nat, fb, jhmm.decode_segment(scores, 17, len(scores) - 9)
    if name == "detect_chrom":
        rec = seeded_record(seed, 20_000)
        o = rng.poisson(2.0, len(rec.codes)).astype(np.int64)
        o[3000:4500] += 9
        o[12000:12400] += 6
        run = lambda: detect_chrom(40, 10, 0, 2.1, 60.0, 40, o, rec.segments)
        nat, fb = native_and_fallback(monkeypatch, run)
        return nat, fb, jax_det.detect_chrom(40, 10, 0, 2.1, 60.0, 40, o,
                                             rec.segments)
    raise ValueError(name)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("name", ["chain", "word_counts", "score_bases",
                                  "derivatives", "viterbi", "decode_segment",
                                  "detect_chrom"])
def test_native_binding_equals_fallback_and_jax(name, seed, monkeypatch):
    nat, fb, jax = binding_case(name, seed, monkeypatch)
    assert nat is not None
    if isinstance(nat, list):
        assert nat == fb == jax
        assert nat
        return
    assert nat.dtype == fb.dtype == jax.dtype
    assert np.array_equal(nat, fb) and np.array_equal(nat, jax)
    if name == "chain":
        assert (nat > 0).any()


def test_hmm_read_write_round_trip(tmp_path):
    """-hmo text written by the port reads back to the same logs and the
    same bytes, and the JAX reader takes it."""
    from meshclust2_tpu.red.hmm import HMM as JaxHMM

    hmm = random_hmm(3, 4)
    hmm.write(str(tmp_path / "a.hmm"))
    back = HMM.read(str(tmp_path / "a.hmm"))
    back.write(str(tmp_path / "b.hmm"))
    assert (tmp_path / "a.hmm").read_bytes() == (tmp_path / "b.hmm").read_bytes()
    j = JaxHMM.read(str(tmp_path / "a.hmm"))
    assert np.array_equal(j.p_log, back.p_log) and np.array_equal(j.t_log, back.t_log)
