"""The plane singles on the port: markov, sim_mm, rre_k_r, spearman, d2s,
d2_star, afd, n2r, n2rc and n2rrc through the plane store, the
plane-singles kernel's plain version and the fused kernel's PLANE epilogue,
against the JAX package, on small.fasta at k = 5 (and k = 2 for afd), with
--device cpu (the kernels' plain versions).

- The planes: each port plane (markov's log tables gathered by each row's
  counts and group sums, the int16 2 dev halved) cast to float32 equals the
  JAX DeviceFeatureEngine's (the two log planes, which the JAX package
  takes with float32 logs, within one float32 ulp), and each plane row
  equals, bit for bit, the intermediate the JAX host oracle forms for that
  row in a pair batch, whatever the row chunks of the build; the log
  tables equal numpy's logs over every row, and a table that does not
  stops the build; the store holds only what a model reads.
- The raw singles, both forms: within their bounds of the JAX float64 host
  oracle (`compute_singles`), the bounds at most 1e-9 (|v| + 1); within the
  JAX tests' float32 tolerances of the JAX device engine's `singles_batch`.
- The decision: s and dist of a plane model and of a model with full-vector
  and plane singles within s_err / dist_err of the JAX CompiledModel on the
  host singles.
- The CLI, three models (markov: intersection, markov, sim_mm, rre_k_r;
  plane: spearman, d2s, d2_star, n2rc; k2: manhattan, afd, n2r, n2rrc): the
  CLSTR byte for byte the JAX --device host run's, the engine counters the
  JAX sessionless --device tpu run's (its DeviceScorer on every batch), a
  session with the scorer alone and its stderr line; again under a forced
  wide margin, which re-checks more pairs.
- fastcar with a plane model keeps the host route, byte for byte.
- afd at k != 2 raises on the scorer, as on the host.
- On the card (`cuda`): the kernel within bounds of its plain version in
  both forms and of the host oracle at every team mapping (one pair, a
  window no multiple of the split, 20,000 pairs, D = 16 and 4,096,
  uint16), NaN at a bad index, and the fused kernel's PLANE epilogue in
  its rounds and in the FULL kernel's teams.
"""
import os

import numpy as np
import pytest
import torch

from meshclust2_tpu_torch import cli as torch_cli

from test_torch_slow_feats import DEVICE_ENV, FIXTURES, counters

torch.set_num_threads(2)

SMALL = os.path.join(FIXTURES, "small.fasta")
# the JAX package's sessionless device configuration: its DeviceScorer on
# every batch (a plane model gets no device session there either)
SESSIONLESS = {"MC2_NO_DEVICE_SESSION": "1", "MC2_DEVICE_THRESHOLD": "0"}
# the k and histogram width of each model's pool
MODEL_K = {"markov": (5, "uint8_t"), "plane": (5, "uint8_t"),
           "k2": (2, "uint16_t")}


def specs():
    """The three models' (singles, combos), as chip_smoke.py:plane_specs
    gives them."""
    from meshclust2_tpu_torch.features import flags as F

    return {
        "markov": ([F.FEAT_MARKOV, F.FEAT_INTERSECTION, F.FEAT_RRE_K_R,
                    F.FEAT_SIM_MM],
                   [("xy", F.FEAT_INTERSECTION),
                    ("xy", F.FEAT_MARKOV | F.FEAT_SIM_MM),
                    ("xy", F.FEAT_RRE_K_R)]),
        "plane": ([F.FEAT_SPEARMAN, F.FEAT_D2s, F.FEAT_D2_star, F.FEAT_N2RC],
                  [("xy", F.FEAT_SPEARMAN),
                   ("xy", F.FEAT_D2s | F.FEAT_D2_star),
                   ("xy", F.FEAT_N2RC)]),
        "k2": ([F.FEAT_MANHATTAN, F.FEAT_AFD, F.FEAT_N2R, F.FEAT_N2RRC],
               [("xy", F.FEAT_MANHATTAN),
                ("xy", F.FEAT_AFD | F.FEAT_N2R),
                ("xy", F.FEAT_N2RRC)]),
    }


def fitted_block(ps, singles, combos):
    """A ModelBlock over the JAX host singles of 600 random pairs, fitted as
    the JAX tests fit theirs (seed 0, template labels, least squares of +-4
    on the combos, each a product of its singles)."""
    from meshclust2_tpu.features import flags as F
    from meshclust2_tpu.features import host as H
    from meshclust2_tpu.model.weights import ModelBlock

    rng = np.random.default_rng(0)
    a_rows = rng.integers(0, ps.n, 600)
    b_rows = rng.integers(0, ps.n, 600)
    keep = a_rows != b_rows
    a_rows, b_rows = a_rows[keep], b_rows[keep]
    raw = H.compute_singles(singles, H.side_from_pointset(ps, a_rows),
                            H.side_from_pointset(ps, b_rows))
    mins, maxs = raw.min(axis=0), raw.max(axis=0)
    z = (raw - mins) / np.where(maxs > mins, maxs - mins, 1.0)
    is_sim = np.array([bool(F.FEAT_IS_SIM[s]) for s in singles])
    z = np.where(is_sim[None, :], z, 1.0 - z)
    label = lambda rows: np.array([ps.headers[r].split("_")[0] for r in rows])
    y = np.where(label(a_rows) == label(b_rows), 1.0, -1.0)
    cols = [np.prod([z[:, singles.index(f)] for f in F.split_flags(fl)], axis=0)
            for _, fl in combos]
    w, *_ = np.linalg.lstsq(np.column_stack([np.ones(len(y))] + cols),
                            y * 4.0, rcond=None)
    return ModelBlock(combos=combos, weights=w, singles=singles, mins=mins,
                      maxs=maxs)


def jax_pool(k, datatype):
    from meshclust2_tpu.cli import load_sorted_points

    return load_sorted_points([SMALL], [], k, datatype, False,
                              keep_seqs_train=False)[1]


def port_pool(k, datatype):
    return torch_cli.load_sorted_points([SMALL], [], k, datatype, False,
                                        keep_seqs_train=False)[1]


def all_flags(k):
    from meshclust2_tpu_torch.features import flags as F
    from meshclust2_tpu_torch.model.classifier import PLANE_SINGLES

    return [f for f in PLANE_SINGLES if k == 2 or f != F.FEAT_AFD]


@pytest.fixture(scope="module")
def pools():
    """{k: (JAX PointSet, port PointSet, port plane store over every plane
    single the k takes)} for small.fasta."""
    from meshclust2_tpu_torch.cluster.device_store import DeviceStore
    from meshclust2_tpu_torch.ops.device_features import TorchDeviceFeatureEngine

    out = {}
    for k, datatype in ((5, "uint8_t"), (2, "uint16_t")):
        pps = port_pool(k, datatype)
        eng = TorchDeviceFeatureEngine(pps, all_flags(k),
                                       DeviceStore.from_pointset(pps, "cpu"))
        out[k] = (jax_pool(k, datatype), pps, eng)
    return out


def pairs(n, seed=1, size=300):
    """Random pairs over n rows, the first few of a row with itself."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n, size)
    b = rng.integers(0, n, size)
    b[:5] = a[:5]
    return a, b


# the planes the JAX package builds in float64 and casts to float32
CAST_PLANES = {"markov_self": "markov_self", "rank_dev": "rank_dev",
               "rank_ss": "rank_dev_ss", "h": "h_plane", "n2r": "n2r",
               "n2rc": "n2rc", "n2rrc": "n2rrc"}
# the planes it takes with float32 logs
LOG_PLANES = {"log_counts": "log_counts", "log_groups": "log_group_sums"}


def dense_planes(pl):
    """The port's plane store as the JAX engine's per-row planes, float64
    numpy: the log tables gathered by each row's counts and group sums,
    the integer 2 dev halved; the other planes as they are."""
    counts = pl.counts.numpy().astype(np.int64)
    n, d = counts.shape
    out = {name: getattr(pl, name).numpy() for name in
           ("markov_self", "rank_ss", "h", "n2r", "n2rc", "n2rrc")}
    out["log_counts"] = pl.log_count.numpy()[counts]
    out["log_groups"] = pl.log_group.numpy()[counts.reshape(n, d // 4, 4).sum(axis=2)]
    out["rank_dev"] = pl.rank2.numpy() / 2.0
    return out


@pytest.mark.parametrize("k", [5, 2])
def test_planes_equal_jax_engine_planes(pools, k):
    from meshclust2_tpu.ops.device_features import DeviceFeatureEngine

    jps, _, eng = pools[k]
    je = DeviceFeatureEngine(jps, all_flags(k))
    pl = eng.planes
    dense = dense_planes(pl)
    for port, name in CAST_PLANES.items():
        got = dense[port].astype(np.float32)
        assert np.array_equal(got, np.asarray(je.planes[name])), name
    for port, name in LOG_PLANES.items():
        got = dense[port].astype(np.float32).view(np.int32)
        want = np.asarray(je.planes[name]).view(np.int32)
        assert np.abs(got.astype(np.int64) - want).max() <= 1, name
    for name in ("mags", "one_mers", "real_mags"):
        got = getattr(pl, name).numpy().astype(np.float32)
        assert np.array_equal(got, np.asarray(getattr(je, name))), name


@pytest.mark.parametrize("k", [5, 2])
def test_plane_rows_equal_host_intermediates(pools, k, monkeypatch):
    """Each plane row, built over the pool in row chunks, equals the value
    the JAX host oracle forms for that row inside a pair batch, bit for
    bit (row sums included), and a build in other chunks gives the same
    bits."""
    from meshclust2_tpu.features import flags as F
    from meshclust2_tpu.features import host as H
    from meshclust2_tpu_torch.cluster.device_store import DeviceStore
    from meshclust2_tpu_torch.ops.device_features import TorchDeviceFeatureEngine

    jps, pps, eng = pools[k]
    pl = eng.planes
    dense = dense_planes(pl)
    a, b = pairs(jps.n, seed=2)
    A, B = H.side_from_pointset(jps, a), H.side_from_pointset(jps, b)
    d = jps.dim
    # markov: log(gp) and log(psum) as H.markov forms them, from the tables
    gq = A.counts.reshape(len(a), d // 4, 4)
    assert np.array_equal(dense["log_counts"][a].view(np.int64),
                          np.log(gq).reshape(len(a), d).view(np.int64))
    assert np.array_equal(dense["log_groups"][a].view(np.int64),
                          np.log(gq.sum(axis=2, keepdims=True))[:, :, 0].view(np.int64))
    assert np.array_equal(pl.markov_self.numpy()[a], H.markov(A, A))
    # spearman: the rank deviations (stored doubled, exact integers) and
    # their sums of squares; cov from the integers is the host's bit for bit
    dp = H.tiedrank(A.counts) - (d + 1) / 2.0
    dq = H.tiedrank(B.counts) - (d + 1) / 2.0
    assert pl.rank2.dtype == torch.int16
    assert np.array_equal(dense["rank_dev"][a], dp)
    assert np.array_equal(pl.rank_ss.numpy()[a], (dp * dp).sum(axis=1))
    r2 = pl.rank2.numpy().astype(np.int64)
    assert np.array_equal((r2[a] * r2[b]).sum(axis=1) * 0.25, (dp * dq).sum(axis=1))
    # d2s, d2_star: counts - the expectation
    assert np.array_equal(pl.h.numpy()[a], A.counts - H._expected_counts(A)[0])
    # n2*: the dot of the z-planes is the host's value bit for bit
    for flag, z in ((F.FEAT_N2R, pl.n2r), (F.FEAT_N2RC, pl.n2rc),
                    (F.FEAT_N2RRC, pl.n2rrc)):
        z = z.numpy()
        assert np.array_equal((z[a] * z[b]).sum(axis=1),
                              H.compute_singles([flag], A, B)[:, 0])
    monkeypatch.setattr(TorchDeviceFeatureEngine, "ROW_CHUNK", 7)
    other = TorchDeviceFeatureEngine(pps, all_flags(k),
                                     DeviceStore.from_pointset(pps, "cpu")).planes
    for name in ("log_count", "log_group", "markov_self", "rank2",
                 "rank_ss", "h", "n2r", "n2rc", "n2rrc"):
        assert torch.equal(getattr(other, name), getattr(pl, name)), name


@pytest.mark.parametrize("form", ["pair", "center"])
@pytest.mark.parametrize("k", [5, 2])
def test_plane_singles_within_bounds_of_host_oracle(pools, k, form):
    from meshclust2_tpu.features import flags as F
    from meshclust2_tpu.features import host as H
    from meshclust2_tpu_torch.ops.plane_singles import plane_singles

    jps, _, eng = pools[k]
    flags = all_flags(k)
    a, b = pairs(jps.n)
    if form == "center":
        b = np.full(len(a), 7)
    b_t = torch.from_numpy(b if form == "pair" else b[:1])
    got = plane_singles(eng.planes, torch.from_numpy(a), b_t, flags).numpy()
    want = H.compute_singles(flags, H.side_from_pointset(jps, a),
                             H.side_from_pointset(jps, b))
    for j, flag in enumerate(flags):
        v, e, w = got[0, j], got[1, j], want[:, j]
        name = F.FEAT_NAMES[flag]
        assert np.isfinite(v).all() and np.isfinite(e).all(), name
        assert (np.abs(v - w) <= e).all(), name
        assert (e <= 1e-9 * (np.abs(w) + 1)).all(), name


@pytest.mark.parametrize("k", [5, 2])
def test_log_tables_equal_host_logs_bit_for_bit(pools, k):
    """markov's tables (log c and the log of a group sum over every value
    the store's type holds) give, at every count of every row, the very
    logs the host oracle takes of the row (H.markov: np.log of the grouped
    counts and of their sums)."""
    _, pps, eng = pools[k]
    pl = eng.planes
    d = pps.dim
    c = pps.counts.astype(np.float64)
    ci = pps.counts.astype(np.int64)
    n_log = 256 if pps.counts.dtype == np.uint8 else 65536
    assert pl.log_count.shape == (n_log,) and pl.log_group.shape == (4 * (n_log - 1) + 1,)
    got = pl.log_count.numpy()[ci]
    assert np.array_equal(got.view(np.int64), np.log(c).view(np.int64))
    gq = c.reshape(len(c), d // 4, 4)
    got = pl.log_group.numpy()[ci.reshape(len(c), d // 4, 4).sum(axis=2)]
    want = np.log(gq.sum(axis=2, keepdims=True))[:, :, 0]
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


def test_plane_store_refuses_a_table_that_is_not_the_hosts():
    """The build's check: a table entry one ulp off the host's log raises."""
    from meshclust2_tpu_torch.ops.device_features import LogTableMismatch, check_logs

    rows = np.log(np.arange(1.0, 65.0)).reshape(4, 16)
    with np.errstate(divide="ignore"):
        table = np.log(np.arange(65.0))
    check_logs(rows, table[np.arange(1, 65).reshape(4, 16)], "log c")
    table[17] = np.nextafter(table[17], 0.0)
    with pytest.raises(LogTableMismatch, match="log c"):
        check_logs(rows, table[np.arange(1, 65).reshape(4, 16)], "log c")


@pytest.mark.parametrize("name", list(MODEL_K))
def test_plane_store_holds_only_what_the_model_reads(name):
    """The plane store of a model: no per-row log planes (markov reads two
    tables), spearman's deviations as int16, only the planes its singles
    read; its bytes are those tensors' and nothing else."""
    from meshclust2_tpu_torch.cluster.device_store import DeviceStore
    from meshclust2_tpu_torch.model.classifier import PLANE_SINGLES
    from meshclust2_tpu_torch.ops.device_features import TorchDeviceFeatureEngine
    from meshclust2_tpu_torch.ops.plane_singles import NEEDS

    k, datatype = MODEL_K[name]
    singles = specs()[name][0]
    pps = port_pool(k, datatype)
    pl = TorchDeviceFeatureEngine(pps, singles,
                                  DeviceStore.from_pointset(pps, "cpu")).planes
    names = set().union(*(NEEDS[f] for f in singles if f in PLANE_SINGLES))
    tensors = {n: t for n, t in vars(pl).items() if isinstance(t, torch.Tensor)}
    assert set(tensors) == names | {"counts", "mags", "real_mags", "one_mers"}
    n, d = pps.n, pps.dim
    per_row = {"log_count": 0, "log_group": 0, "markov_self": 8, "rank2": 2 * d,
               "rank_ss": 8, "h": 8 * d, "n2r": 8 * d, "n2rc": 8 * d, "n2rrc": 8 * d}
    n_log = 256 if datatype == "uint8_t" else 65536
    want = n * (8 + 32) + sum(n * per_row[m] for m in names)
    if "log_count" in names:
        want += 8 * (n_log + 4 * (n_log - 1) + 1)
    assert pl.nbytes() == want
    if "rank2" in names:
        assert pl.rank2.dtype == torch.int16


def test_rank_deviations_widen_to_int32_past_16384():
    from meshclust2_tpu_torch.ops.plane_singles import rank_dtype

    assert rank_dtype(4 ** 7) == torch.int16     # |2 dev| <= 16,383
    assert rank_dtype(4 ** 8) == torch.int32


def test_plane_singles_on_med2000_within_bounds_of_host_oracle():
    """The plain version over the tables and int16 ranks on med2000 (k = 5,
    uint8), both forms: every plane single within its bound of the JAX
    package's float64 host oracle."""
    from meshclust2_tpu.cli import load_sorted_points
    from meshclust2_tpu.features import host as H
    from meshclust2_tpu_torch.cluster.device_store import DeviceStore
    from meshclust2_tpu_torch.ops.device_features import TorchDeviceFeatureEngine
    from meshclust2_tpu_torch.ops.plane_singles import plane_singles

    med = os.path.join(FIXTURES, "med2000.fasta")
    jps = load_sorted_points([med], [], 5, "uint8_t", False, keep_seqs_train=False)[1]
    pps = torch_cli.load_sorted_points([med], [], 5, "uint8_t", False,
                                       keep_seqs_train=False)[1]
    flags = all_flags(5)
    eng = TorchDeviceFeatureEngine(pps, flags, DeviceStore.from_pointset(pps, "cpu"))
    a, b = pairs(jps.n, seed=7, size=200)
    for bb in (b, np.full(len(a), 13)):
        b_t = torch.from_numpy(bb if bb is b else bb[:1])
        got = plane_singles(eng.planes, torch.from_numpy(a), b_t, flags).numpy()
        want = H.compute_singles(flags, H.side_from_pointset(jps, a),
                                 H.side_from_pointset(jps, bb))
        assert (np.abs(got[0] - want.T) <= got[1]).all()
        assert (got[1] <= 1e-9 * (np.abs(want.T) + 1)).all()


@pytest.mark.parametrize("k", [5, 2])
def test_plane_singles_within_jax_engine_tolerance(pools, k):
    """Against the JAX device engine's float32 singles, with the JAX tests'
    own tolerances (tests/test_device_features.py:45-50)."""
    from meshclust2_tpu.features import flags as F
    from meshclust2_tpu.ops.device_features import DeviceFeatureEngine
    from meshclust2_tpu_torch.ops.plane_singles import plane_singles_ref

    jps, _, eng = pools[k]
    flags = all_flags(k)
    a, b = pairs(jps.n, seed=3, size=64)
    want = DeviceFeatureEngine(jps, flags).singles_batch(a, b)
    got = plane_singles_ref(eng.planes, torch.from_numpy(a), torch.from_numpy(b),
                            flags).numpy()
    loose = {F.FEAT_D2_star, F.FEAT_D2s, F.FEAT_SIM_MM, F.FEAT_MARKOV,
             F.FEAT_RRE_K_R, F.FEAT_KL_COND}
    for j, flag in enumerate(flags):
        np.testing.assert_allclose(got[0, j], want[:, j],
                                   rtol=5e-3 if flag in loose else 5e-4,
                                   atol=5e-5, err_msg=F.FEAT_NAMES[flag])


def decision_models():
    """The three models' singles and combos, and one with a full-vector
    single beside plane singles (the FULL and PLANE epilogue)."""
    from meshclust2_tpu_torch.features import flags as F

    out = {name: (MODEL_K[name][0],) + spec for name, spec in specs().items()}
    out["full_plane"] = (5, [F.FEAT_HELLINGER, F.FEAT_MARKOV,
                             F.FEAT_INTERSECTION, F.FEAT_SPEARMAN],
                         [("xy", F.FEAT_INTERSECTION),
                          ("xy2", F.FEAT_HELLINGER | F.FEAT_MARKOV),
                          ("x2y2", F.FEAT_SPEARMAN)])
    return out


@pytest.mark.parametrize("form", ["pair", "center"])
@pytest.mark.parametrize("name", ["markov", "plane", "k2", "full_plane"])
def test_decision_within_bounds_of_jax_model(pools, name, form):
    from meshclust2_tpu.features import host as H
    from meshclust2_tpu.model.classifier import CompiledModel as JaxModel
    from meshclust2_tpu_torch.cluster.device_store import DeviceStore
    from meshclust2_tpu_torch.model.classifier import (PLANE_SINGLES,
                                                       CompiledModel,
                                                       model_to_torch)
    from meshclust2_tpu_torch.model.weights import ModelBlock
    from meshclust2_tpu_torch.ops.pair_stats import pair_stats_decision
    from meshclust2_tpu_torch.ops.plane_singles import plane_singles

    k, singles, combos = decision_models()[name]
    jps, pps, eng = pools[k]
    block = fitted_block(jps, singles, combos)
    a, b = pairs(jps.n, seed=4)
    if form == "center":
        b = np.full(len(a), 11)
    want_s, _, want_d = JaxModel(block).decision_from_raw(H.compute_singles(
        singles, H.side_from_pointset(jps, a), H.side_from_pointset(jps, b)))
    params = model_to_torch(CompiledModel(ModelBlock(
        combos=combos, weights=block.weights, singles=singles,
        mins=block.mins, maxs=block.maxs)), "cpu")
    a_t = torch.from_numpy(a)
    b_t = torch.from_numpy(b if form == "pair" else b[:1])
    pflags = [s for s in singles if s in PLANE_SINGLES]
    plane = plane_singles(eng.planes, a_t, b_t, pflags)
    store = DeviceStore.from_pointset(pps, "cpu")
    with pytest.raises(ValueError, match="plane singles"):
        pair_stats_decision(store, params, a_t, b_t)
    _, dec = pair_stats_decision(store, params, a_t, b_t, plane)
    s, dist, s_err, dist_err = (dec[r].numpy() for r in (0, 2, 3, 4))
    assert (np.abs(s - want_s) <= s_err).all()
    assert (np.abs(dist - want_d) <= dist_err).all()
    assert (s_err > 0).all() and (s_err <= 1e-8 * (np.abs(want_s) + 1)).all()


def plane_weights(tmp_path_factory, name):
    from meshclust2_tpu.model.weights import PredictorModel, save_weights

    k, datatype = MODEL_K[name]
    singles, combos = specs()[name]
    ps = jax_pool(k, datatype)
    path = str(tmp_path_factory.mktemp("w") / f"{name}_weights.txt")
    save_weights(path, PredictorModel(
        k=k, mode=1, max_features=4, id_cutoff=0.9, datatype=datatype,
        feature_set=int(np.bitwise_or.reduce(singles)),
        classifier=fitted_block(ps, singles, combos)))
    return path


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return {name: plane_weights(tmp_path_factory, name) for name in MODEL_K}


def jax_cli(tmp_path, monkeypatch, weights, device, env):
    """The JAX CLI on small.fasta: (CLSTR bytes, its engine counters)."""
    from meshclust2_tpu.cli import main as jax_main
    from meshclust2_tpu.cluster import engine as jax_engine

    got = {}
    real = jax_engine.MeanShiftEngine.run

    def run(self, *args, **kw):
        out = real(self, *args, **kw)
        got["res"] = self
        return out

    with monkeypatch.context() as m:
        for key in DEVICE_ENV:
            m.delenv(key, raising=False)
        for key, v in env.items():
            m.setenv(key, v)
        m.setattr(jax_engine.MeanShiftEngine, "run", run)
        out = tmp_path / f"jax_{device}.clstr"
        assert jax_main(["--device", device, "--recover", weights, "--output",
                         str(out), SMALL]) == 0
    return out.read_bytes(), counters(got["res"])


def port_cli(tmp_path, monkeypatch, capsys, weights, env=None):
    for key in DEVICE_ENV:
        monkeypatch.delenv(key, raising=False)
    for key, v in (env or {}).items():
        monkeypatch.setenv(key, v)
    out = tmp_path / "port.clstr"
    capsys.readouterr()
    res = torch_cli.run(["--device", "cpu", "--recover", weights, "--output",
                         str(out), SMALL])
    assert res.rc == 0
    return res, out.read_bytes(), capsys.readouterr().err


@pytest.mark.parametrize("name", list(MODEL_K))
def test_cli_equals_jax_host(weights, tmp_path, monkeypatch, capsys, name):
    from meshclust2_tpu_torch.ops.device_features import TorchDeviceScorer

    want, host_c = jax_cli(tmp_path, monkeypatch, weights[name], "host", {})
    _, tpu_c = jax_cli(tmp_path, monkeypatch, weights[name], "tpu", SESSIONLESS)
    res, got, err = port_cli(tmp_path, monkeypatch, capsys, weights[name])
    assert got == want
    assert counters(res.engine) == tpu_c == host_c
    assert res.accumulator is None and res.updater is None
    assert isinstance(res.scorer, TorchDeviceScorer)
    assert res.scorer.engine is not None and res.scorer.scored_pairs > 0
    lines = [ln for ln in err.splitlines() if ln.startswith("meshclust2-torch")]
    assert len(lines) == 1 and "device scorer" in lines[0], err
    assert "host scorer" not in err


@pytest.mark.parametrize("name", list(MODEL_K))
def test_cli_forced_margin_equals_jax_host(weights, tmp_path, monkeypatch,
                                          capsys, name):
    want, _ = jax_cli(tmp_path, monkeypatch, weights[name], "host", {})
    res0, _, _ = port_cli(tmp_path, monkeypatch, capsys, weights[name])
    res, got, _ = port_cli(tmp_path, monkeypatch, capsys, weights[name],
                           {"MC2_DD_MARGIN": "3e-3"})
    assert got == want
    assert res.scorer.margin == 3e-3
    assert res.scorer.rechecked_pairs > res0.scorer.rechecked_pairs


def test_fastcar_plane_model_takes_the_host_route(weights, tmp_path,
                                                  monkeypatch, capsys):
    from test_torch_fastcar import assert_same_output, both, split

    db, q = split(tmp_path, "small.fasta", 150, 10)
    res, port_dir, jax_dir = both(tmp_path, monkeypatch, capsys,
                                  [db, "-q", q, "--recover", weights["plane"]])
    assert_same_output(port_dir, jax_dir)
    assert res.stats.device_blocks == 0
    assert (port_dir / "stderr.txt").read_text().splitlines() == [
        "fastcar-torch: features ['d2_star', 'd2s', 'n2rc', 'spearman'] have "
        "no device implementation: searching on the host scorer"]


def test_afd_at_k5_raises_on_the_scorer_as_on_the_host(pools):
    from meshclust2_tpu.features import flags as F
    from meshclust2_tpu.features import host as H
    from meshclust2_tpu_torch.model.classifier import CompiledModel
    from meshclust2_tpu_torch.model.weights import ModelBlock
    from meshclust2_tpu_torch.ops.device_features import TorchDeviceScorer

    jps, pps, _ = pools[5]
    with pytest.raises(ValueError, match="AFD requires k == 2"):
        H.compute_singles([F.FEAT_AFD], H.side_from_pointset(jps, [0]),
                          H.side_from_pointset(jps, [1]))
    model = CompiledModel(ModelBlock(combos=[("xy", F.FEAT_AFD)],
                                     weights=[0.0, 1.0], singles=[F.FEAT_AFD],
                                     mins=[0.0], maxs=[1.0]))
    with pytest.raises(ValueError, match="AFD requires k == 2"):
        TorchDeviceScorer(pps, model, "cpu")


def test_refusals_split_scorer_and_loops():
    from meshclust2_tpu_torch.features import flags as F
    from meshclust2_tpu_torch.ops.device_features import (loop_refusal,
                                                          scorer_refusal)

    plane = [F.FEAT_INTERSECTION, F.FEAT_MARKOV, F.FEAT_N2RC]
    assert scorer_refusal(plane) is None
    assert loop_refusal(plane) == \
        "features ['markov', 'n2rc'] have no device implementation"
    assert loop_refusal([F.FEAT_HELLINGER, F.FEAT_EMD]) is None
    assert scorer_refusal([F.FEAT_ALIGN, F.FEAT_MARKOV]) == \
        "features ['align'] have no device implementation"


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def cuda_engine(k, dtype, n=300, device="cuda"):
    """A plane store on the card over random rows (eight near-identical
    pairs among them) of a k-mer pool, every plane single the k takes."""
    from meshclust2_tpu_torch.cluster.device_store import DeviceStore
    from meshclust2_tpu_torch.kmer.counting import PointSet
    from meshclust2_tpu_torch.ops.device_features import TorchDeviceFeatureEngine

    rng = np.random.default_rng(5)
    d = 4 ** k
    counts = rng.integers(1, 60 if dtype == np.uint8 else 1000, (n, d))
    counts[8:16] = counts[:8]
    counts[8:16, :max(2, d // 100)] += 1
    counts = counts.astype(dtype)
    c64 = counts.astype(np.int64)
    ps = PointSet(counts=counts, one_mers=rng.integers(1, 400, (n, 4)).astype(np.uint64),
                  lengths=rng.integers(700, 1500, n).astype(np.int64),
                  mags=c64.sum(axis=1), stddevs=rng.random(n) * 3 + 0.5,
                  headers=[f"s{i}" for i in range(n)], ids=np.arange(n), k=k)
    store = DeviceStore.from_pointset(ps, device)
    return ps, store, TorchDeviceFeatureEngine(ps, all_flags(k), store)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["pair", "center"])
@pytest.mark.parametrize("k,dtype", [(5, np.uint8), (5, np.uint16), (2, np.uint16)])
def test_cuda_plane_singles_within_bounds_of_plain(k, dtype, form):
    from meshclust2_tpu_torch.ops.plane_singles import (plane_singles,
                                                        plane_singles_ref)

    _cuda_or_skip()
    ps, _, eng = cuda_engine(k, dtype)
    a = torch.arange(0, 300, device="cuda")
    b = (torch.remainder(a + 8, 300) if form == "pair"
         else torch.tensor([8], device="cuda"))
    before = plane_singles.launches
    got = plane_singles(eng.planes, a, b, all_flags(k))
    torch.cuda.synchronize()
    assert plane_singles.launches == before + 1
    want = plane_singles_ref(eng.planes, a, b, all_flags(k))
    assert torch.isfinite(got).all()
    assert ((got[0] - want[0]).abs() <= got[1] + want[1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["markov", "full_plane"])
def test_cuda_plane_decision_within_bounds_of_plain(name):
    from meshclust2_tpu_torch.model.classifier import (PLANE_SINGLES,
                                                       CompiledModel,
                                                       model_to_torch)
    from meshclust2_tpu_torch.model.weights import ModelBlock
    from meshclust2_tpu_torch.ops.pair_stats import (pair_stats_decision,
                                                     pair_stats_decision_ref)
    from meshclust2_tpu_torch.ops.plane_singles import plane_singles

    _cuda_or_skip()
    _, singles, combos = decision_models()[name]
    ps, store, eng = cuda_engine(5, np.uint8)
    rng = np.random.default_rng(6)
    params = model_to_torch(CompiledModel(ModelBlock(
        combos=combos, weights=rng.normal(0.0, 2.0, len(combos) + 1),
        singles=singles, mins=[-1e4, 0.0, 0.0, -1.0], maxs=[1e4, 1.0, 2.0, 1.0])),
        "cuda")
    a = torch.arange(0, 300, device="cuda")
    for b in (torch.remainder(a + 8, 300), torch.tensor([8], device="cuda")):
        plane = plane_singles(eng.planes, a, b,
                              [s for s in singles if s in PLANE_SINGLES])
        before = pair_stats_decision.plane_launches
        stats, dec = pair_stats_decision(store, params, a, b, plane)
        torch.cuda.synchronize()
        assert pair_stats_decision.plane_launches == before + 1
        p_stats, p_dec = pair_stats_decision_ref(store, params, a, b, plane)
        assert torch.equal(stats, p_stats)
        for r, e in ((0, 3), (2, 4)):
            assert ((dec[r] - p_dec[r]).abs() <= dec[e] + p_dec[e]).all()


# the kernels' mappings (a team of S warps a pair, chosen by the pair count
# and D): one pair, a window not a multiple of the split, enough pairs for
# one warp a pair, D = 16 and D = 4,096, uint16 counts, an index outside
# the store
MAPPING_CASES = {
    "center W=1": (5, np.uint8, "center", 1),
    "center W=37": (5, np.uint8, "center", 37),
    "pair P=20000": (5, np.uint8, "pair", 20_000),
    "k=2 uint16 pair": (2, np.uint16, "pair", 500),
    "k=2 uint16 center": (2, np.uint16, "center", 300),
    "k=6 D=4096 center": (6, np.uint8, "center", 300),
    "k=5 uint16 center": (5, np.uint16, "center", 77),
}


def mapping_pairs(case, n):
    k, dtype, form, size = MAPPING_CASES[case]
    rng = np.random.default_rng(len(case))
    a = rng.integers(0, n, size)
    a[:min(8, size)] = np.arange(min(8, size))
    if form == "center":
        return torch.from_numpy(a).cuda(), torch.tensor([8], device="cuda")
    b = rng.integers(0, n, size)
    b[:8] = np.arange(8, 16)
    return torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(MAPPING_CASES))
def test_cuda_plane_singles_mappings_within_bounds(case):
    """Each mapping: every plane single within the sum of both bounds of
    the plain version and within the kernel's bound of the port's numpy
    host oracle."""
    from meshclust2_tpu_torch.features import host as H
    from meshclust2_tpu_torch.ops.plane_singles import (plane_singles,
                                                        plane_singles_ref)

    _cuda_or_skip()
    k, dtype, _, _ = MAPPING_CASES[case]
    ps, _, eng = cuda_engine(k, dtype)
    a, b = mapping_pairs(case, ps.n)
    flags = all_flags(k)
    got = plane_singles(eng.planes, a, b, flags)
    torch.cuda.synchronize()
    want = plane_singles_ref(eng.planes, a, b, flags)
    assert torch.isfinite(got).all()
    assert ((got[0] - want[0]).abs() <= got[1] + want[1]).all()
    a_np, b_np = a.cpu().numpy(), b.expand(len(a)).cpu().numpy()
    host = H.compute_singles(flags, H.side_from_pointset(ps, a_np),
                             H.side_from_pointset(ps, b_np))
    k_np = got.cpu().numpy()
    assert (np.abs(k_np[0] - host.T) <= k_np[1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["pair", "center"])
def test_cuda_plane_singles_bad_index_gives_nan(form):
    from meshclust2_tpu_torch.ops.plane_singles import plane_singles

    _cuda_or_skip()
    ps, _, eng = cuda_engine(5, np.uint8)
    flags = all_flags(5)
    a = torch.tensor([3, ps.n, 4, -1], device="cuda")
    b = (torch.tensor([5, 6, 7, 8], device="cuda") if form == "pair"
         else torch.tensor([9], device="cuda"))
    got = plane_singles(eng.planes, a, b, flags)
    bad_center = plane_singles(eng.planes, a[:1], torch.tensor([ps.n], device="cuda"),
                               flags)
    torch.cuda.synchronize()
    assert torch.isfinite(got[:, :, [0, 2]]).all()
    assert torch.isnan(got[:, :, [1, 3]]).all()
    assert torch.isnan(bad_center).all()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["markov", "plane", "full_plane"])
@pytest.mark.parametrize("case", ["center W=1", "center W=37", "pair P=20000"])
def test_cuda_plane_decision_mappings_within_bounds(case, name):
    """The PLANE epilogue in the fused kernel's rounds (one pair a lane;
    a round of one pair over the warp) and, with full-vector singles, in
    the FULL kernel's teams: statistics bit for bit the plain version's, s
    and dist within both bounds of it."""
    from meshclust2_tpu_torch.model.classifier import (PLANE_SINGLES,
                                                       CompiledModel,
                                                       model_to_torch)
    from meshclust2_tpu_torch.model.weights import ModelBlock
    from meshclust2_tpu_torch.ops.pair_stats import (pair_stats_decision,
                                                     pair_stats_decision_ref)
    from meshclust2_tpu_torch.ops.plane_singles import plane_singles

    _cuda_or_skip()
    _, singles, combos = decision_models()[name]
    ps, store, eng = cuda_engine(5, np.uint8)
    rng = np.random.default_rng(6)
    params = model_to_torch(CompiledModel(ModelBlock(
        combos=combos, weights=rng.normal(0.0, 2.0, len(combos) + 1),
        singles=singles, mins=[-1e4, -1.0, 0.0, -1.0], maxs=[1e4, 1.0, 2.0, 1e3])),
        "cuda")
    a, b = mapping_pairs(case, ps.n)
    plane = plane_singles(eng.planes, a, b, [s for s in singles if s in PLANE_SINGLES])
    stats, dec = pair_stats_decision(store, params, a, b, plane)
    torch.cuda.synchronize()
    p_stats, p_dec = pair_stats_decision_ref(store, params, a, b, plane)
    assert torch.equal(stats, p_stats)
    for r, e in ((0, 3), (2, 4)):
        assert ((dec[r] - p_dec[r]).abs() <= dec[e] + p_dec[e]).all()
    assert (dec[3] > 0).all()
