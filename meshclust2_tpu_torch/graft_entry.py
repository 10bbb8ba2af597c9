"""The port's counterparts of the entry points of __graft_entry__.py, the
JAX package's: `entry` and `dryrun_multichip`.

entry() -> (forward, example_args): one forward step of the classifier on
the card, a block of candidate histograms against one center through the
center form of the fused pair-statistics kernel
(ops/pair_stats.py:pair_stats_decision), with parallel/mesh.py's float32
epilogue (classify_kernel_factory) beside it on the same statistics.

dryrun_multichip(n_devices): n_devices processes, one rank each (NCCL, one
card a rank, where the machine has that many cards; gloo on the CPU
otherwise), run the seven sections of the JAX dry run over the port on
small shapes:
  1. the sharded k-mer histogram build, a saturating record among them,
     against the native counter;
  2. the center scores, row-sharded, against the same epilogue unsharded;
  3. the mean update (sums and argmin over the ranks) against numpy;
  4. the GLM solve against the weights the data was made from;
  5. MeshScorer's clustering against the host scorer's;
  6. the sharded accumulate loop and update phase
     (parallel/multihost_session.py) against the host engine's accumulate
     and update;
  7. build_multihost_session's session under the engine against the host
     clustering.
A failed section fails its rank, and any failed rank fails the call.

    python -m meshclust2_tpu_torch.graft_entry 2          # two ranks
    python -m meshclust2_tpu_torch.graft_entry 2 --cpu    # gloo on the CPU
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
from typing import Optional

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# seconds a dry run's ranks may take together
DRYRUN_TIMEOUT_S = 600.0


def _toy_model():
    """The JAX entry's toy classifier (__graft_entry__.py:_toy_model)."""
    from .features import flags as F
    from .model.classifier import CompiledModel
    from .model.weights import ModelBlock

    singles = [F.FEAT_MANHATTAN, F.FEAT_INTERSECTION, F.FEAT_EUCLIDEAN,
               F.FEAT_KULCZYNSKI2]
    block = ModelBlock(
        combos=[("xy", F.FEAT_MANHATTAN | F.FEAT_INTERSECTION),
                ("x2y2", F.FEAT_EUCLIDEAN | F.FEAT_KULCZYNSKI2),
                ("xy2", F.FEAT_MANHATTAN | F.FEAT_EUCLIDEAN)],
        weights=np.array([-1.2, 2.0, 1.0, -0.5]),
        singles=singles,
        mins=np.array([0.0, 0.2, 0.0, 100.0]),
        maxs=np.array([500.0, 1.0, 60.0, 5000.0]),
    )
    return CompiledModel(block)


def _toy_pointset(n: int, k: int, seed: int = 0):
    """n random records of 120-200 bases, uint16 histograms."""
    from .io.fasta import encode_sequence
    from .kmer.counting import build_point_set

    rng = np.random.default_rng(seed)
    recs = [encode_sequence(f">toy{i}", "".join(rng.choice(list("ACGT"),
                                                            rng.integers(120, 200))))
            for i in range(n)]
    return build_point_set(recs, k, "uint16_t")


def _template_pointset(n_templates: int, per: int, k: int, seed: int):
    """Families of near-copies of a template (2 % substitutions): decisions
    far from the classifier's edges, one cluster a family."""
    from .io.fasta import encode_sequence
    from .kmer.counting import build_point_set

    rng = np.random.default_rng(seed)
    recs = []
    for t in range(n_templates):
        tmpl = rng.integers(0, 4, int(rng.integers(150, 190)))
        for j in range(per):
            sub = rng.random(len(tmpl)) < 0.02
            seq = np.where(sub, rng.integers(0, 4, len(tmpl)), tmpl)
            recs.append(encode_sequence(f">t{t}_{j}", "".join("ACGT"[c] for c in seq)))
    return build_point_set(recs, k, "uint16_t")


def _device(device):
    import torch

    from .runtime import resolve_device

    return resolve_device("cuda" if device is None else device) \
        if device in (None, "cuda") else torch.device(device)


def entry(device=None):
    """(forward, (a_idx, b_idx)): forward(a_idx, b_idx) classifies the
    candidates a_idx against the one center b_idx on `device` (None: the
    card, raising without one; "cpu" runs the kernel's plain version) and
    returns (prob, dist) of the fused kernel's float64 epilogue and (prob,
    dist) of classify_kernel_factory's float32 epilogue on the same
    statistics; a toy 64-row point set (k = 4) and the toy model."""
    import torch

    from .cluster.device_store import DeviceStore
    from .model.classifier import model_to_torch
    from .ops.pair_stats import derive_singles, pair_stats_decision
    from .parallel.mesh import classify_kernel_factory

    dev = _device(device)
    k = 4
    model = _toy_model()
    ps = _toy_pointset(64, k)
    store = DeviceStore.from_pointset(ps, dev)
    params = model_to_torch(model, dev)
    epilogue = classify_kernel_factory(model.weights, model.mins, model.maxs, model.is_sim,
                                       model.combos)

    def forward(a_idx: torch.Tensor, b_idx: torch.Tensor):
        stats, dec = pair_stats_decision(store, params, a_idx, b_idx)
        b = b_idx.expand(len(a_idx))
        raw = derive_singles(stats, store.mags[a_idx], store.mags[b], store.selfdot[a_idx],
                             store.selfdot[b], store.stddevs[a_idx], store.stddevs[b],
                             store.lens[a_idx], store.lens[b], ps.dim, model.singles)
        prob32, dist32 = epilogue(raw.to(torch.float32))
        return dec[1], dec[2], prob32, dist32

    a_idx = torch.arange(64, dtype=torch.int64, device=dev)
    b_idx = torch.zeros(1, dtype=torch.int64, device=dev)
    return forward, (a_idx, b_idx)


def dryrun_multichip(n_devices: int, device: Optional[str] = None,
                     timeout: float = DRYRUN_TIMEOUT_S) -> None:
    """The seven sections (module docstring) on n_devices ranks, one
    process each, over a file rendezvous; NCCL on cuda:<rank> where
    `device` is "cuda", or None and the machine has n_devices cards; gloo
    on the CPU otherwise.  Raises RuntimeError naming the failed ranks,
    with the end of their output."""
    import torch

    if device is None:
        device = ("cuda" if torch.cuda.is_available()
                  and torch.cuda.device_count() >= n_devices else "cpu")
    with tempfile.TemporaryDirectory(prefix="mc2_dryrun_") as tmp:
        init = os.path.join(tmp, "rendezvous")
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        env.setdefault("OMP_NUM_THREADS", "1")
        procs = [subprocess.Popen(
            [sys.executable, "-m", "meshclust2_tpu_torch.graft_entry", "--rank", str(r),
             str(n_devices), "--init", init, "--device", device],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(n_devices)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                p.kill()
    bad = [(r, p.returncode, log) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    if bad:
        raise RuntimeError("dryrun_multichip: " + "; ".join(
            f"rank {r} exited {rc}:\n{log[-3000:]}" for r, rc, log in bad))


def _section(name: str, fn) -> None:
    try:
        fn()
    except Exception as e:
        raise RuntimeError(f"dry run section {name} failed: {type(e).__name__}: {e}") from e


def _rank_main(rank: int, world: int, init: str, device: str) -> int:
    """One rank of dryrun_multichip: the seven sections in order."""
    import torch
    import torch.distributed as dist

    from .parallel import mesh as M

    dev = torch.device("cuda", rank) if device == "cuda" else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(M.backend_for(dev, world), init_method=f"file://{init}",
                            rank=rank, world_size=world)
    mesh = M.make_mesh(dev)
    for name, fn in (("1 (k-mer build)", _kmer_build), ("2 (center scores)", _center_scores),
                     ("3 (mean update)", _mean_update), ("4 (GLM solve)", _glm_solve),
                     ("5 (MeshScorer clustering)", _mesh_scorer),
                     ("6 (sharded accumulate and update)", _sharded_phases),
                     ("7 (build_multihost_session)", _session_run)):
        _section(name, lambda fn=fn: fn(mesh))
        if rank == 0:
            print(f"dry run section {name}: ok", flush=True)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def _kmer_build(mesh) -> None:
    import torch

    from .io.fasta import encode_sequence
    from .kmer.counting import build_point_set
    from .parallel.mesh import block_bounds, device_build_counts, gather_rows

    rng = np.random.default_rng(1)
    recs = [encode_sequence(f">r{i}", "".join(rng.choice(list("ACGTN"), 400,
                                                          p=[0.24] * 4 + [0.04])))
            for i in range(8 * mesh.world)]
    recs[0] = encode_sequence(">homopolymer", "A" * 600)   # saturates uint8
    lo, hi, _ = block_bounds(len(recs), mesh.world, mesh.rank)
    counts, ones = device_build_counts(recs[lo:hi], 5, 255, device=mesh.device)
    got = gather_rows(mesh, torch.from_numpy(counts).to(mesh.device), len(recs)).cpu().numpy()
    want = build_point_set(recs, 5, "uint8_t")
    np.testing.assert_array_equal(got, want.counts)
    assert int(got.max()) == 255, "the saturating record did not saturate"


def _singles_fn(H_local, center):
    import torch

    s_min = torch.minimum(H_local, center[None, :]).sum(dim=1)
    s_abs = (H_local - center[None, :]).abs().sum(dim=1)
    inter = 2 * s_min / (H_local.sum(dim=1) + center.sum())
    return torch.stack([s_abs, inter], dim=1)


def _center_scores(mesh) -> None:
    import torch

    from .parallel import mesh as M

    n, d = 64 * mesh.world, 256
    rng = np.random.default_rng(2)
    H = torch.from_numpy(rng.integers(0, 20, (n, d)).astype(np.float32)).to(mesh.device)
    epi = M.classify_kernel_factory(np.array([-1.0, 1.5, 2.5]), np.array([0.0, 0.0]),
                                    np.array([float(2 * 20 * d), 1.0]),
                                    np.array([False, True]),
                                    (("xy", (0, 1)), ("x2y2", (0, 1))))
    lo, hi, _ = M.block_bounds(n, mesh.world, mesh.rank)
    prob, dist_ = M.sharded_center_scores(mesh, _singles_fn, epi)(H[lo:hi], H[0])
    prob = M.gather_rows(mesh, prob, n)
    dist_ = M.gather_rows(mesh, dist_, n)
    want_p, want_d = epi(_singles_fn(H, H[0]))
    torch.testing.assert_close(prob, want_p, rtol=1e-6, atol=0)
    torch.testing.assert_close(dist_, want_d, rtol=1e-6, atol=0)


def _mean_update(mesh) -> None:
    import torch

    from .parallel import mesh as M

    n, d, C = 48 * mesh.world, 64, 4
    rng = np.random.default_rng(3)
    H = rng.integers(0, 20, (n, d)).astype(np.float32)
    mask = (rng.random((C, n)) < 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    lo, hi, _ = M.block_bounds(n, mesh.world, mesh.rank)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(mesh.device)
    gmin, garg = M.sharded_mean_update(mesh)(t(H[lo:hi]), t(H[lo:hi].sum(axis=1)),
                                             t(mask[:, lo:hi]),
                                             t(np.arange(lo, hi, dtype=np.int32)))
    # numpy: the reference's distance_d to the mean, first strict minimum
    for c in range(C):
        rows = np.nonzero(mask[c])[0]
        top = H[rows].sum(axis=0) / len(rows)
        dd = 2 * np.minimum(H[rows], np.floor(top + 0.5)).sum(axis=1)
        mag = np.trunc(H[rows] + top).sum(axis=1)
        v = 10000.0 * (1.0 - (dd / mag) ** 2)
        assert int(garg[c]) == rows[int(np.argmin(v))], f"center {c}: argmin differs"
        np.testing.assert_allclose(float(gmin[c]), v.min(), rtol=1e-5)


def _glm_solve(mesh) -> None:
    import torch

    from .parallel import mesh as M

    n = 64 * mesh.world
    rng = np.random.default_rng(4)
    X = np.concatenate([np.ones((n, 1)), rng.standard_normal((n, 3))], axis=1)
    w = np.array([0.5, 1.0, -2.0, 0.25])
    lo, hi, _ = M.block_bounds(n, mesh.world, mesh.rank)
    got = M.sharded_glm_solve(mesh)(torch.from_numpy(X[lo:hi]).to(mesh.device),
                                    torch.from_numpy((X @ w)[lo:hi]).to(mesh.device))
    np.testing.assert_allclose(got.cpu().numpy(), w, atol=1e-9)


def _clusters(clusters) -> list:
    return sorted((c.center_row, tuple(sorted(c.members)))
                  for c in clusters if not getattr(c, "deleted", False))


def _mesh_scorer(mesh) -> None:
    from .cluster.engine import HostScorer, MeanShiftEngine
    from .parallel.mesh_scorer import MeshScorer

    model = _toy_model()
    ps = _toy_pointset(48 * mesh.world, 4, seed=5)
    sc = MeshScorer.create(ps, model, mesh=mesh)
    assert sc is not None, "MeshScorer refused the toy pool"
    got = MeanShiftEngine(ps, model, 0.9, scorer=sc).run()
    want = MeanShiftEngine(ps, model, 0.9, scorer=HostScorer(ps, model)).run()
    assert _clusters(got) == _clusters(want), "MeshScorer clustering != host scorer's"


def _template_case(mesh):
    """The template pool and the small fixture's trained model (the toy
    model where the fixture is absent), with the host engine's accumulate
    and whole clustering."""
    from .cluster.bvec import BVec
    from .cluster.engine import HostScorer, MeanShiftEngine
    from .model.classifier import CompiledModel
    from .model.weights import load_weights

    ps = _template_pointset(2 * mesh.world + 2, 6, 5, seed=11)
    fixture = os.path.join(ROOT, "tests", "fixtures", "small_ref_weights.txt")
    model = (CompiledModel(load_weights(fixture).classifier) if os.path.exists(fixture)
             else _toy_model())
    eng = MeanShiftEngine(ps, model, 0.9, scorer=HostScorer(ps, model))
    bv = BVec(ps.lengths, eng.bin_size)
    bv.insert_all(ps.lengths)
    bv.insert_finalize(ps.lengths)
    acc = [(c.center_row, list(c.members)) for c in eng.accumulate_all(bv)]
    whole = MeanShiftEngine(ps, model, 0.9, scorer=HostScorer(ps, model)).run()
    return ps, model, acc, [(c.center_row, list(c.members)) for c in whole]


def _sharded_phases(mesh) -> None:
    from .cluster.engine import Cluster
    from .parallel.multihost_session import pointset_session

    ps, model, host_acc, host_out = _template_case(mesh)
    session, _ = pointset_session(ps, model, 0.9, mesh)
    raw, state = session.accumulator.run(session.bv)
    assert state is None, "the sharded accumulate loop aborted on the dry run's data"
    assert [(c, list(m)) for c, m in raw] == host_acc, \
        "sharded accumulate != host accumulate"
    res = session.phase.run([Cluster(center_row=c, members=list(m)) for c, m in raw])
    assert res.abort == 0, "the sharded update phase aborted"
    assert [(c, list(m)) for c, m in res.clusters] == host_out, \
        "sharded update phase != host update phase"


def _session_run(mesh) -> None:
    from .cluster.engine import MeanShiftEngine
    from .parallel.multihost_session import pointset_session

    ps, model, _, host_out = _template_case(mesh)
    session, fetch = pointset_session(ps, model, 0.9, mesh)
    engine = MeanShiftEngine(ps, model, 0.9, scorer=session.scorer,
                             device_session=session)
    engine.row_fetcher = fetch
    got = [(c.center_row, list(c.members)) for c in engine.run()]
    assert got == host_out, "the multihost session's clustering != host clustering"


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="python -m meshclust2_tpu_torch.graft_entry")
    p.add_argument("n_devices", type=int)
    p.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--init", default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.rank is not None:
        return _rank_main(args.rank, args.n_devices, args.init, args.device)
    dryrun_multichip(args.n_devices, device="cpu" if args.cpu else None)
    print(f"dryrun_multichip({args.n_devices}): ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
