"""The port's MeshScorer (meshclust2_tpu_torch/parallel/mesh_scorer.py) in
gloo groups of 1 and 2 processes (tests/torch_dist_worker.py, spawned once
for this file) against the JAX package's MeshScorer over the 8-device CPU
mesh and the float64 host scorer, on small.fasta with its model, with and
without --bias: every row against three centers and a mixed-center batch
give the host's rounded decisions and distance argmax (as
tests/test_mesh_scorer.py holds the JAX scorer), a mixed batch halved to
fit a small unique-row bound gives the same, and the engine driven by it
gives the host scorer's clusters.  Marked cuda: the scorer on a one-rank
NCCL group against the same scorer on the CPU."""
import numpy as np
import pytest
import torch

import torch_dist_worker as W

WORLDS = (1, 2)
BIASES = (0.0, 0.3)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return W.spawn("scorer", WORLDS, str(tmp_path_factory.mktemp("scorer")))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's pool, its mesh scorer and host scorer, and the
    host engine's clusters, for each bias."""
    import os

    from meshclust2_tpu.cli import load_sorted_points
    from meshclust2_tpu.cluster.engine import HostScorer, MeanShiftEngine
    from meshclust2_tpu.model.classifier import CompiledModel
    from meshclust2_tpu.model.weights import load_weights
    from meshclust2_tpu.parallel.mesh_scorer import MeshScorer

    w = load_weights(os.path.join(W.FIXTURES, "small_ref_weights.txt"))
    _, ps = load_sorted_points([os.path.join(W.FIXTURES, "small.fasta")], [], w.k,
                               w.datatype, False)
    out = {}
    for bias in BIASES:
        model = CompiledModel(w.classifier, bias=bias)
        host = HostScorer(ps, model)
        eng = MeanShiftEngine(ps, model, w.id_cutoff, scorer=HostScorer(ps, model))
        out[bias] = dict(ps=ps, mesh=MeshScorer.create(ps, model), host=host,
                         clusters=W.clusters_array(eng.run()))
    return out


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_agree(groups, world):
    first = groups[world][0]
    for other in groups[world][1:]:
        for key, v in first.items():
            np.testing.assert_array_equal(other[key], v, err_msg=key)


def test_create_requires_supported_singles():
    from types import SimpleNamespace

    from meshclust2_tpu_torch.features import flags as F
    from meshclust2_tpu_torch.parallel.mesh import make_mesh
    from meshclust2_tpu_torch.parallel.mesh_scorer import MESH_SUPPORTED, MeshScorer

    from meshclust2_tpu.parallel.mesh_scorer import MESH_SUPPORTED as JAX_SUPPORTED

    assert MESH_SUPPORTED == JAX_SUPPORTED
    _, ps, model = W.scorer_setup()
    mesh = make_mesh("cpu")
    assert MeshScorer.create(ps, model, mesh=mesh) is not None
    assert MeshScorer.create(ps, SimpleNamespace(singles=[F.FEAT_MARKOV]), mesh=mesh) is None


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("bias", BIASES)
def test_decisions_match_jax_and_host(groups, jax_side, world, bias):
    got = groups[world][0]
    js = jax_side[bias]
    n = js["ps"].n
    rows = np.arange(n)
    for i, c in enumerate(W.center_rows(n)):
        b = np.full(n, c % n)
        p_j, d_j = js["mesh"].score(rows, b)
        p_h, d_h = js["host"].score(rows, b)
        p, d = got[f"b{bias}_prob_{i}"], got[f"b{bias}_dist_{i}"]
        np.testing.assert_array_equal(np.floor(p + 0.5), np.floor(p_h + 0.5))
        np.testing.assert_array_equal(np.floor(p + 0.5), np.floor(p_j + 0.5))
        assert int(np.argmax(d)) == int(np.argmax(d_h)) == int(np.argmax(d_j))
    rng = np.random.default_rng(3)
    a, b = rng.integers(0, n, 400), rng.integers(0, n, 400)
    p_h, d_h = js["host"].score(a, b)
    np.testing.assert_array_equal(np.floor(got[f"b{bias}_pair_prob"] + 0.5),
                                  np.floor(p_h + 0.5))
    p_j, _ = js["mesh"].score_center_all(3)
    np.testing.assert_array_equal(np.floor(got[f"b{bias}_all_prob"] + 0.5),
                                  np.floor(p_j + 0.5))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("bias", BIASES)
def test_full_clustering_equals_host(groups, jax_side, world, bias):
    got = groups[world][0]
    np.testing.assert_array_equal(got[f"b{bias}_clusters"], jax_side[bias]["clusters"])
    rechecked, scored = got[f"b{bias}_rechecked"]
    assert 0 < rechecked < scored


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("bias", BIASES)
def test_halved_pair_batch_matches_host(groups, jax_side, world, bias):
    """A mixed batch over more unique rows than MAX_PAIR_UNIQUE_ROWS is
    halved until each part fits, every part through the kernel's pair form:
    every pair counted as scored, the host's rounded decisions, and the
    whole batch's values within 1e-12 relative."""
    got = groups[world][0]
    n = jax_side[bias]["ps"].n
    rng = np.random.default_rng(3)
    a, b = rng.integers(0, n, 400), rng.integers(0, n, 400)
    p_h, _ = jax_side[bias]["host"].score(a, b)
    splits, scored = got[f"b{bias}_splits"]
    assert splits >= 400 // W.SPLIT_BOUND and scored == 3 * n + 2 * 400
    np.testing.assert_array_equal(np.floor(got[f"b{bias}_split_prob"] + 0.5),
                                  np.floor(p_h + 0.5))
    for key in ("prob", "dist"):
        np.testing.assert_allclose(got[f"b{bias}_split_{key}"], got[f"b{bias}_pair_{key}"],
                                   rtol=1e-12, atol=0)


@pytest.mark.parametrize("bound", [2, 16, 64])
def test_halving_scores_every_pair_in_parts_that_fit(bound):
    """In one process: each part the scorer's pair form receives holds at
    most `bound` unique rows or is halved, the host oracle sees only
    re-checks, and the values are the whole batch's."""
    from meshclust2_tpu_torch.parallel.mesh import make_mesh
    from meshclust2_tpu_torch.parallel.mesh_scorer import MeshScorer

    _, ps, model = W.scorer_setup()
    sc = MeshScorer.create(ps, model, mesh=make_mesh("cpu"))
    rng = np.random.default_rng(5)
    a, b = rng.integers(0, ps.n, 300), rng.integers(0, ps.n, 300)
    p0, d0 = sc.score(a, b)
    sc.MAX_PAIR_UNIQUE_ROWS = bound
    parts, host_pairs = [], []
    real, real_host = sc._pair_decision, sc._host.score

    def spy(x, y):
        parts.append(len(np.unique(np.concatenate([x, y]))))
        return real(x, y)

    def host_spy(x, y):
        host_pairs.append(len(x))
        return real_host(x, y)

    sc._pair_decision, sc._host.score = spy, host_spy
    rechecked = sc.rechecked_pairs
    p, d = sc.score(a, b)
    assert sc.scored_pairs == 2 * len(a) and sc.split_batches > 0
    assert len(parts) == 2 * sc.split_batches + 1
    assert sum(u <= bound for u in parts) == sc.split_batches + 1
    assert sum(host_pairs) == sc.rechecked_pairs - rechecked
    np.testing.assert_allclose(p, p0, rtol=1e-12, atol=0)
    np.testing.assert_allclose(d, d0, rtol=1e-12, atol=0)


def test_mesh_defaults_to_the_card(monkeypatch):
    """Without a device, make_mesh and MeshScorer take the card; without
    one they raise instead of running on the CPU."""
    from meshclust2_tpu_torch.parallel.mesh import make_mesh
    from meshclust2_tpu_torch.parallel.mesh_scorer import MeshScorer

    _, ps, model = W.scorer_setup()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        MeshScorer.create(ps, model)


@pytest.mark.cuda
def test_cuda_nccl_world_1_equals_cpu():
    """The scorer on a one-rank NCCL group on the card, against the same
    scorer on the CPU (gloo, the kernels' plain versions): every center's
    and a mixed batch's rounded decisions and distance argmax equal, the
    values within 1e-12 relative (the float64 epilogue rounds in another
    order on the CPU: ~1 ulp), and the same clusters."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    import torch.distributed as dist

    from meshclust2_tpu_torch.cluster.engine import MeanShiftEngine
    from meshclust2_tpu_torch.ops.pair_stats import pair_stats_decision
    from meshclust2_tpu_torch.parallel.mesh import make_mesh
    from meshclust2_tpu_torch.parallel.mesh_scorer import MeshScorer

    w, ps, model = W.scorer_setup()
    res = {}
    launches = pair_stats_decision.launches
    for name, device in (("cuda", None), ("cpu", "cpu")):
        # one default group a process: a one-rank NCCL group for the card,
        # then a gloo one for the CPU
        if dist.is_initialized():
            dist.destroy_process_group()
        mesh = make_mesh(device)
        if name == "cuda":
            assert (mesh.world, mesh.device.type, dist.get_backend()) == (1, "cuda", "nccl")
        sc = MeshScorer.create(ps, model, mesh=mesh)
        rows = np.arange(ps.n)
        rng = np.random.default_rng(3)
        a, b = rng.integers(0, ps.n, 400), rng.integers(0, ps.n, 400)
        res[name] = [sc.score(rows, np.full(ps.n, c % ps.n)) for c in W.center_rows(ps.n)]
        res[name].append(sc.score(a, b))
        eng = MeanShiftEngine(ps, model, w.id_cutoff, scorer=sc)
        res[name].append(W.clusters_array(eng.run()))
    dist.destroy_process_group()
    assert pair_stats_decision.launches > launches
    for (p, d), (p0, d0) in zip(res["cuda"][:-1], res["cpu"][:-1]):
        np.testing.assert_array_equal(np.floor(p + 0.5), np.floor(p0 + 0.5))
        assert int(np.argmax(d)) == int(np.argmax(d0))
        np.testing.assert_allclose(p, p0, rtol=1e-12, atol=0)
        np.testing.assert_allclose(d, d0, rtol=1e-12, atol=0)
    np.testing.assert_array_equal(res["cuda"][-1], res["cpu"][-1])
