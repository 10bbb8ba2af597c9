"""The port's fastcar (`meshclust2_tpu_torch.fastcar`, --device cpu: the
kernels' plain versions) against the JAX package's fastcar in its default
host route, byte for byte on `<output>0`, the `# of predicted positive`
line and the weights a training run writes.  The fixtures are the splits of
tests/test_fastcar_device.py (med2000: 250 db / 30 queries) and
tests/test_fastcar_recover.py (small: 150 / 10)."""
import os

import numpy as np
import pytest
import torch

from meshclust2_tpu import fastcar as jax_fastcar
from meshclust2_tpu_torch import fastcar as port_fastcar
from meshclust2_tpu_torch.cluster import device_search

torch.set_num_threads(2)

# the fixtures' directory without conftest.py's fixture, which imports jax:
# the cuda-marked tests run with --noconftest on the card's machine
FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


def split(tmp, name, n_db, n_q):
    recs = []
    cur = None
    for line in open(os.path.join(FIXTURES, name)):
        line = line.rstrip("\n")
        if line.startswith(">"):
            cur = [line, []]
            recs.append(cur)
        elif line and cur:
            cur[1].append(line)
    db, q = tmp / "db.fasta", tmp / "q.fasta"
    for path, part in ((db, recs[:n_db]), (q, recs[n_db:n_db + n_q])):
        with open(path, "w") as f:
            for h, s in part:
                f.write(h + "\n" + "\n".join(s) + "\n")
    return str(db), str(q)


@pytest.fixture(scope="module")
def med(tmp_path_factory):
    """The med2000 split and the weights of the JAX fastcar's training."""
    tmp = tmp_path_factory.mktemp("fc_med")
    db, q = split(tmp, "med2000.fasta", 250, 30)
    weights = str(tmp / "fc_weights.txt")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        assert jax_fastcar.main([db, "-q", q, "--id", "0.9", "-m", "rc",
                                 "--mut-type", "single", "--dump",
                                 weights]) == 0
    finally:
        os.chdir(cwd)
    return db, q, weights


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return split(tmp_path_factory.mktemp("fc_small"), "small.fasta", 150, 10)


def both(tmp_path, monkeypatch, capsys, argv, device="cpu"):
    """The JAX fastcar's host route and the port's run of argv, each in a
    directory of its own (a training run writes weights.txt there): (the
    port's FastcarRun, its directory, the JAX run's directory); each run's
    `<output>0` holds its matches, `stdout.txt` and `stderr.txt` its
    standard output and error."""
    monkeypatch.delenv("MC2_FASTCAR_DEVICE", raising=False)
    dirs = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        args = [*argv, "-o", str(d / "out.search")]
        if side == "jax":
            assert jax_fastcar.main(args) == 0
        else:
            res = port_fastcar.run(["--device", device, *args])
            assert res.rc == 0
        captured = capsys.readouterr()
        (d / "stdout.txt").write_text(captured.out)
        (d / "stderr.txt").write_text(captured.err)
        dirs[side] = d
    return res, dirs["port"], dirs["jax"]


def assert_same_output(port_dir, jax_dir, n_files=1):
    for t in range(n_files):
        got = (port_dir / f"out.search{t}").read_bytes()
        assert got == (jax_dir / f"out.search{t}").read_bytes()
    assert len(list(port_dir.glob("out.search*"))) == n_files

    def positives(d):
        return [ln for ln in (d / "stdout.txt").read_text().splitlines()
                if ln.startswith("# of predicted positive")]

    assert positives(port_dir) == positives(jax_dir)
    assert len(positives(port_dir)) == 1


def test_recover_med2000(med, tmp_path, monkeypatch, capsys):
    db, q, weights = med
    res, port_dir, jax_dir = both(tmp_path, monkeypatch, capsys,
                                  [db, "-q", q, "--recover", weights])
    assert_same_output(port_dir, jax_dir)
    st = res.stats
    assert (st.blocks, st.device_blocks, st.host_reasons) == (1, 1, [])
    assert st.pairs > res.positives > 20
    assert len((port_dir / "out.search0").read_text().splitlines()) > 20


def test_several_blocks(med, tmp_path, monkeypatch, capsys):
    db, q, weights = med
    res, port_dir, jax_dir = both(tmp_path, monkeypatch, capsys,
                                  [db, "-q", q, "--recover", weights,
                                   "-c", "40"])
    assert_same_output(port_dir, jax_dir)
    # 7 blocks of <= 40 db rows; one holds no query's window
    assert (res.stats.blocks, res.stats.device_blocks) == (7, 6)


def test_noformat_and_thread_files(med, tmp_path, monkeypatch, capsys):
    db, q, weights = med
    _, port_dir, jax_dir = both(tmp_path, monkeypatch, capsys,
                                [db, "-q", q, "--recover", weights,
                                 "--noformat", "-t", "3"])
    assert_same_output(port_dir, jax_dir, n_files=3)
    assert "!" in (port_dir / "out.search0").read_text()
    assert (port_dir / "out.search2").read_bytes() == b""


def test_forced_margin_rechecks_every_pair(med, tmp_path, monkeypatch, capsys):
    """MC2_DD_MARGIN=1e9 sends every classifier pair and every kept pair's
    regression value to the host route's scorer."""
    db, q, weights = med
    monkeypatch.setenv("MC2_DD_MARGIN", "1e9")
    res, port_dir, jax_dir = both(tmp_path, monkeypatch, capsys,
                                  [db, "-q", q, "--recover", weights])
    assert_same_output(port_dir, jax_dir)
    assert res.stats.rechecked_c == res.stats.pairs
    assert res.stats.rechecked_r == res.positives > 0


@pytest.mark.parametrize("mode", ["c", "r"])
def test_train_and_search_in_one_mode(small, tmp_path, monkeypatch, capsys,
                                      mode):
    """Training in one mode, then the search with that model: the same
    weights.txt and output files."""
    db, q = small
    res, port_dir, jax_dir = both(tmp_path, monkeypatch, capsys,
                                  [db, "-q", q, "--id", "0.9", "-m", mode,
                                   "--mut-type", "single"])
    assert_same_output(port_dir, jax_dir)
    assert (port_dir / "weights.txt").read_bytes() == \
        (jax_dir / "weights.txt").read_bytes()
    assert (res.trained.classifier is None) == (mode == "r")
    assert (res.trained.regressor is None) == (mode == "c")
    assert res.stats.device_blocks == 1


def test_dump_weights(small, tmp_path, monkeypatch, capsys):
    db, q = small
    args = [db, "-q", q, "--id", "0.9", "-m", "rc", "--mut-type", "single",
            "--dump"]
    monkeypatch.chdir(tmp_path)
    assert jax_fastcar.main([*args, str(tmp_path / "jax_w.txt")]) == 0
    res = port_fastcar.run(["--device", "cpu", *args,
                            str(tmp_path / "port_w.txt")])
    assert res.rc == 0 and res.trained.regressor is not None
    assert (tmp_path / "port_w.txt").read_bytes() == \
        (tmp_path / "jax_w.txt").read_bytes()
    assert not (tmp_path / "weights.txt").exists()


@pytest.mark.parametrize("datatype,reason", [("16", None),
                                             ("32", "uint32 histograms")])
def test_datatype(small, tmp_path, monkeypatch, capsys, datatype, reason):
    """uint16 histograms go through the store; uint32 ones are searched
    (and trained) on the host, with a stderr line naming the reason."""
    db, q = small
    res, port_dir, jax_dir = both(tmp_path, monkeypatch, capsys,
                                  [db, "-q", q, "--id", "0.9", "-m", "rc",
                                   "--mut-type", "single", "--datatype",
                                   datatype])
    err = (port_dir / "stderr.txt").read_text()
    assert_same_output(port_dir, jax_dir)
    assert (port_dir / "weights.txt").read_bytes() == \
        (jax_dir / "weights.txt").read_bytes()
    if reason is None:
        assert res.stats.device_blocks == 1 and res.stats.host_reasons == []
        assert "fastcar-torch" not in err
    else:
        assert res.stats.device_blocks == 0
        assert res.stats.host_reasons == [
            f"{reason} (the kernels read uint8/uint16)"]
        assert f"fastcar-torch: {reason}" in err and "host scorer" in err


def test_device_cuda_raises_without_gpu(small, monkeypatch):
    db, q = small
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_fastcar.run([db, "-q", q, "--id", "0.9"])


def test_parser_defaults_and_device_flag():
    args = port_fastcar.build_parser().parse_args(["x.fasta", "-q", "y"])
    ref = jax_fastcar.build_parser().parse_args(["x.fasta", "-q", "y"])
    assert args.device == "cuda"
    assert {k: v for k, v in vars(args).items() if k != "device"} == vars(ref)


@pytest.mark.parametrize("hdr", [">seq1 template_3", "seq1", ">abc", ">",
                                 "", ">a\tb c", "a b", ">  lead", ">x\t"])
def test_format_header(hdr):
    assert port_fastcar.format_header(hdr) == jax_fastcar.format_header(hdr)


BIN_CASES = [([10, 20, 20, 30, 40], v) for v in (20, 50, 5, 10, 40, 25, 30)]


@pytest.mark.parametrize("lens,length", BIN_CASES + [
    (sorted(np.random.default_rng(seed).integers(
        1, 60, int(np.random.default_rng(seed).integers(0, 40)))),
     int(np.random.default_rng(seed + 1000).integers(0, 70)))
    for seed in range(12)])
def test_bin_search(lens, length):
    lens = np.asarray(lens, dtype=np.int64)
    assert port_fastcar.bin_search(lens, length) == \
        jax_fastcar.bin_search(lens, length)


def test_printed_may_differ_covers_the_printed_digits():
    """Every sum whose printed value changes within eps (the JAX package's
    string test) or that lies within eps of 0 or 1 is flagged."""
    rng = np.random.default_rng(7)
    s = np.concatenate([
        rng.random(20_000),
        np.round(rng.random(5_000), 6) + rng.normal(0, 1e-9, 5_000),
        np.round(rng.random(2_000) / 10, 7) + 5e-8,
        rng.normal(0, 1e-8, 500), 1 + rng.normal(0, 1e-8, 500),
        [0.0, 1.0, 0.1, 0.01, 0.001, np.nan, np.inf, -1.0, 2.0]])
    eps = 1e-8 * np.maximum(np.abs(s), 1.0)
    with np.errstate(invalid="ignore"):
        lowp = np.array([f"{100 * v:g}" for v in np.clip(s - eps, 0, 1)])
        highp = np.array([f"{100 * v:g}" for v in np.clip(s + eps, 0, 1)])
        want = (lowp != highp) | (np.abs(s) <= eps) | (np.abs(s - 1) <= eps) \
            | ~np.isfinite(s)
    got = device_search.printed_may_differ(s, eps)
    assert not (want & ~got).any()
    assert want.sum() > 100
    assert got.mean() < 0.2


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [[], ["-c", "40"]])
def test_search_on_the_card_equals_cpu(med, tmp_path, monkeypatch, capsys,
                                       extra):
    _cuda_or_skip()
    from meshclust2_tpu_torch.ops.pair_stats import pair_stats_decision

    db, q, weights = med
    outs = {}
    for device in ("cpu", "cuda"):
        d = tmp_path / device
        d.mkdir()
        pair_stats_decision.launches = 0
        res = port_fastcar.run(["--device", device, db, "-q", q, "--recover",
                                weights, "-o", str(d / "out.search"), *extra])
        # with -c 40 one block of the 7 holds no query's window
        blocks = (1, 1) if not extra else (7, 6)
        assert res.rc == 0
        assert (res.stats.blocks, res.stats.device_blocks) == blocks
        outs[device] = ((d / "out.search0").read_bytes(), res.positives)
        if device == "cuda":
            # each block's classifier slice, and its kept pairs' regression
            # slice where it keeps any
            assert blocks[1] < pair_stats_decision.launches <= 2 * blocks[1]
    assert outs["cpu"] == outs["cuda"]


@pytest.mark.cuda
def test_score_sums_slices_on_the_card(med):
    """score_sums in slices of 1,000 pairs on the card equals one launch of
    all bit for bit, and the plain version on the CPU within float64
    rounding (the CPU's sqrt and exp round otherwise at times)."""
    _cuda_or_skip()
    from meshclust2_tpu_torch.cluster.device_store import DeviceStore
    from meshclust2_tpu_torch.cluster.device_update import TorchDeviceUpdater
    from meshclust2_tpu_torch.kmer.counting import build_point_set
    from meshclust2_tpu_torch.io.fasta import read_fasta
    from meshclust2_tpu_torch.model.classifier import CompiledModel
    from meshclust2_tpu_torch.model.weights import load_weights

    db, _, weights = med
    w = load_weights(weights)
    ps = build_point_set(read_fasta(db), w.k, w.datatype)
    upd = TorchDeviceUpdater(CompiledModel(w.classifier),
                             DeviceStore.from_pointset(ps, torch.device("cuda")))
    rng = np.random.default_rng(3)
    a, b = rng.integers(0, ps.n, 5_500), rng.integers(0, ps.n, 5_500)
    whole = upd.score_sums(a, b)
    assert np.array_equal(upd.score_sums(a, b, slice_pairs=1_000), whole)
    cpu = TorchDeviceUpdater(CompiledModel(w.classifier),
                             DeviceStore.from_pointset(ps, torch.device("cpu")))
    np.testing.assert_allclose(cpu.score_sums(a, b), whole, rtol=1e-12,
                               atol=1e-12)
