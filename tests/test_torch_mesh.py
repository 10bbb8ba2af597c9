"""The port's SPMD functions of meshclust2_tpu_torch/parallel/mesh.py in
gloo groups of 1, 2 and 4 processes (tests/torch_dist_worker.py, spawned
once for this file, a file:// rendezvous) against the JAX package's
programs over the 8-device CPU mesh of tests/conftest.py, on the same seeded
numpy inputs: the histogram build exact (each rank counts its block of
records, the rows all-gathered); the GLM solve within atol 1e-3 of the JAX
float32 solve and 1e-9 of a float64 solve; the mean update's argmin rows
exact and its values within rtol 1e-5; the float32 epilogue and the center
scores behind it within rtol 1e-5.  Every rank's results equal rank 0's.
"""
import numpy as np
import pytest

import torch_dist_worker as W

WORLDS = (1, 2, 4)


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    return W.spawn("mesh", WORLDS, str(tmp_path_factory.mktemp("mesh")))


@pytest.fixture(scope="module")
def mesh8():
    import jax

    from meshclust2_tpu.parallel import mesh as M

    assert len(jax.devices()) >= 8, "conftest should provide 8 virtual devices"
    return M.make_mesh(8)


def _shard(mesh, arr, spec):
    import jax
    from jax.sharding import NamedSharding

    return jax.device_put(arr, NamedSharding(mesh, spec))


def _jax_model(bias):
    from meshclust2_tpu.model.classifier import CompiledModel
    from meshclust2_tpu.model.weights import load_weights

    w = load_weights(W.os.path.join(W.FIXTURES, "small_ref_weights.txt"))
    return CompiledModel(w.classifier, bias=bias)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_agree(groups, world):
    first = groups[world][0]
    for other in groups[world][1:]:
        assert sorted(other) == sorted(first)
        for key, v in first.items():
            np.testing.assert_array_equal(other[key], v, err_msg=key)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("k,dtype_max", [(4, 65535), (5, 255)])
def test_histogram_build_equals_jax(groups, world, k, dtype_max):
    from meshclust2_tpu.io.fasta import encode_sequence
    from meshclust2_tpu.parallel.mesh import device_build_counts

    jc, jo = device_build_counts([encode_sequence(h, s) for h, s in W.records()], k,
                                 dtype_max)
    got = groups[world][0]
    np.testing.assert_array_equal(got[f"counts_k{k}"].astype(np.int64), jc.astype(np.int64))
    np.testing.assert_array_equal(got[f"ones_k{k}"].astype(np.int64), jo.astype(np.int64))


@pytest.mark.parametrize("world", WORLDS)
def test_glm_solve_equals_jax_and_float64(groups, world, mesh8):
    from jax.sharding import PartitionSpec as P

    from meshclust2_tpu.parallel import mesh as M

    inp = W.inputs()
    X, y = inp["X"], inp["y"]
    want = np.asarray(M.sharded_glm_solve(mesh8)(_shard(mesh8, X, P("data")),
                                                 _shard(mesh8, y, P("data"))))
    got = groups[world][0]["glm"]
    X64, y64 = X.astype(np.float64), y.astype(np.float64)
    np.testing.assert_allclose(got, np.linalg.solve(X64.T @ X64, X64.T @ y64), rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(got, want, atol=1e-3)


@pytest.mark.parametrize("world", WORLDS)
def test_mean_update_equals_jax(groups, world, mesh8):
    from jax.sharding import PartitionSpec as P

    from meshclust2_tpu.parallel import mesh as M

    inp = W.inputs()
    # the JAX program's rows must divide over its 8 devices: masked-out padding
    H, mask = inp["H"], inp["mask"]
    pad = (-len(H)) % 8
    Hp = np.concatenate([H, np.ones((pad, H.shape[1]), np.float32)])
    maskp = np.concatenate([mask, np.zeros((mask.shape[0], pad), np.float32)], axis=1)
    rowsp = np.arange(len(Hp), dtype=np.int32)
    gmin, garg = M.sharded_mean_update(mesh8)(
        _shard(mesh8, Hp, P("data")), _shard(mesh8, Hp.sum(axis=1), P("data")),
        _shard(mesh8, maskp, P(None, "data")), _shard(mesh8, rowsp, P("data")))
    got = groups[world][0]
    np.testing.assert_array_equal(got["mean_arg"], np.asarray(garg).astype(np.int64))
    assert got["mean_arg"][-1] == -1 and np.isinf(got["mean_min"][-1])   # the empty center
    np.testing.assert_allclose(got["mean_min"], np.asarray(gmin), rtol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_epilogue_and_center_scores_equal_jax(groups, world, mesh8):
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from meshclust2_tpu.parallel import mesh as M

    model = _jax_model(0.25)
    epi = M.classify_kernel_factory(model.weights, model.mins, model.maxs, model.is_sim,
                                    tuple((k, tuple(i)) for k, i in model.combos),
                                    bias=0.25)
    raw = W.epilogue_raw(model)
    prob, dist = epi(jnp.asarray(raw))
    got = groups[world][0]
    np.testing.assert_allclose(got["epi_prob"], np.asarray(prob), rtol=1e-5)
    np.testing.assert_allclose(got["epi_dist"], np.asarray(dist), rtol=1e-5)
    inp = W.inputs()
    S = len(model.singles)

    def singles_fn(H_local, center):
        diff = H_local - center[None]
        man = jnp.abs(diff).sum(axis=1)
        euc = jnp.sqrt((diff * diff).sum(axis=1))
        return jnp.stack(([man, euc] + [euc / man] * (S - 2))[:S], axis=1)

    H = inp["H"]
    pad = (-len(H)) % 8
    Hp = np.concatenate([H, np.ones((pad, H.shape[1]), np.float32)])
    fn = M.sharded_center_scores(mesh8, singles_fn, epi)
    p, d = fn(_shard(mesh8, Hp, P("data")), _shard(mesh8, inp["center"], P()))
    np.testing.assert_allclose(got["center_prob"], np.asarray(p)[:len(H)], rtol=1e-5)
    np.testing.assert_allclose(got["center_dist"], np.asarray(d)[:len(H)], rtol=1e-5)
