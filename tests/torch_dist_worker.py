"""One rank of a gloo process group for the port's parallel/* tests.

    python tests/torch_dist_worker.py TASK RANK WORLD INIT_FILE OUT_DIR

Forms the group from a file:// rendezvous (no ports), runs TASK's SPMD
functions of meshclust2_tpu_torch.parallel on the CPU over this rank's block
of seeded inputs, and writes what it computed to OUT_DIR/TASK_RANK.npz.
Imports torch and the port only; the tests hold the results against the
JAX package.  Inputs come from `inputs` / `scorer_setup`, which the tests
call too.
"""
from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
# the centers the scorer tests score every row against (small.fasta's
# first, middle and last rows)
CENTERS = (0, "mid", -1)
# the unique-row bound of the scorer task's halved mixed batch
SPLIT_BOUND = 16


def records(seed: int = 21, n: int = 23):
    """(header, sequence) records: random bases salted with runs of N."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        L = int(rng.integers(40, 900))
        s = list(rng.choice(list("ACGT"), L))
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, L - 1))
            for j in range(p, min(L, p + int(rng.integers(1, 40)))):
                s[j] = "N"
        out.append((f"r{i}", "".join(s)))
    return out


def inputs() -> dict:
    """The seeded inputs of the mesh task (numpy)."""
    rng = np.random.default_rng(2026)
    n, d, C = 37, 64, 5
    H = rng.integers(1, 20, size=(n, d)).astype(np.float32)
    mask = (rng.random((C, n)) < 0.4).astype(np.float32)
    mask[:, 0] = 1.0
    mask[C - 1] = 0.0                      # an empty center
    X = np.concatenate([np.ones((64, 1), np.float32),
                        rng.standard_normal((64, 3)).astype(np.float32)], axis=1)
    y = (X @ np.array([1.0, -0.5, 2.0, 0.1], np.float32)
         + 0.01 * rng.standard_normal(64).astype(np.float32))
    center = rng.integers(1, 20, size=d).astype(np.float32)
    return dict(H=H, mags=H.sum(axis=1), mask=mask, rows=np.arange(n, dtype=np.int32),
                X=X, y=y, center=center)


def classifier(bias: float = 0.0):
    """The small fixture's model (the port's CompiledModel)."""
    sys.path.insert(0, ROOT)
    from meshclust2_tpu_torch.model.classifier import CompiledModel
    from meshclust2_tpu_torch.model.weights import load_weights

    w = load_weights(os.path.join(FIXTURES, "small_ref_weights.txt"))
    return w, CompiledModel(w.classifier, bias=bias)


def singles_np(H: np.ndarray, center: np.ndarray, n_singles: int) -> np.ndarray:
    """Raw singles of the mesh task's center scores: manhattan, euclidean,
    then their ratio repeated, in float32 (the same formulas in both
    packages)."""
    man = np.abs(H - center[None]).sum(axis=1)
    euc = np.sqrt(((H - center[None]) ** 2).sum(axis=1))
    cols = [man, euc] + [euc / man] * (n_singles - 2)
    return np.stack(cols[:n_singles], axis=1).astype(np.float32)


def mesh_task(mesh, out: dict) -> None:
    import torch

    from meshclust2_tpu_torch.io.fasta import encode_sequence
    from meshclust2_tpu_torch.parallel import mesh as M

    inp = inputs()
    # the histogram build: each rank counts its block, the rows gathered
    recs = [encode_sequence(h, s) for h, s in records()]
    for k, dtype_max in ((4, 65535), (5, 255)):
        lo, hi, _ = M.block_bounds(len(recs), mesh.world, mesh.rank)
        c, o = M.device_build_counts(recs[lo:hi], k, dtype_max, device="cpu")
        out[f"counts_k{k}"] = M.gather_rows(mesh, torch.from_numpy(c), len(recs)).numpy()
        out[f"ones_k{k}"] = M.gather_rows(mesh, torch.from_numpy(o), len(recs)).numpy()
    n = len(inp["H"])
    lo, hi, _ = M.block_bounds(n, mesh.world, mesh.rank)
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    gmin, garg = M.sharded_mean_update(mesh)(t["H"][lo:hi], t["mags"][lo:hi],
                                              t["mask"][:, lo:hi], t["rows"][lo:hi])
    out["mean_min"], out["mean_arg"] = gmin.numpy(), garg.numpy()
    m = len(inp["X"])
    lo, hi, _ = M.block_bounds(m, mesh.world, mesh.rank)
    out["glm"] = M.sharded_glm_solve(mesh)(t["X"][lo:hi], t["y"][lo:hi]).numpy()
    # the epilogue on its own and behind the sharded center scores
    _, model = classifier(bias=0.25)
    S = len(model.singles)
    epi = M.classify_kernel_factory(model.weights, model.mins, model.maxs, model.is_sim,
                                    model.combos, bias=0.25)
    raw = epilogue_raw(model)
    prob, dist_ = epi(torch.from_numpy(raw))
    out["epi_prob"], out["epi_dist"] = prob.numpy(), dist_.numpy()
    lo, hi, _ = M.block_bounds(n, mesh.world, mesh.rank)

    def singles_fn(H_local, center):
        return torch.from_numpy(singles_np(H_local.numpy(), center.numpy(), S))

    p, d = M.sharded_center_scores(mesh, singles_fn, epi)(t["H"][lo:hi], t["center"])
    out["center_prob"] = M.gather_rows(mesh, p, n).numpy()
    out["center_dist"] = M.gather_rows(mesh, d, n).numpy()


def epilogue_raw(model) -> np.ndarray:
    """Seeded raw singles inside the model's normalisation bounds."""
    rng = np.random.default_rng(7)
    lo, hi = np.asarray(model.mins), np.asarray(model.maxs)
    return (lo + rng.random((50, len(lo))) * (hi - lo)).astype(np.float32)


def scorer_setup(bias: float = 0.0):
    """(weights, the port's sorted small.fasta pool, its model)."""
    sys.path.insert(0, ROOT)
    from meshclust2_tpu_torch.cli import load_sorted_points

    w, model = classifier(bias)
    _, ps = load_sorted_points([os.path.join(FIXTURES, "small.fasta")], [], w.k,
                               w.datatype, False)
    return w, ps, model


def center_rows(n: int):
    return [c if c != "mid" else n // 2 for c in CENTERS]


def scorer_task(mesh, out: dict) -> None:
    from meshclust2_tpu_torch.cluster.engine import MeanShiftEngine
    from meshclust2_tpu_torch.parallel.mesh_scorer import MeshScorer

    for bias in (0.0, 0.3):
        w, ps, model = scorer_setup(bias)
        sc = MeshScorer.create(ps, model, mesh=mesh)
        rows = np.arange(ps.n)
        for i, c in enumerate(center_rows(ps.n)):
            p, d = sc.score(rows, np.full(ps.n, c % ps.n))
            out[f"b{bias}_prob_{i}"], out[f"b{bias}_dist_{i}"] = p, d
        rng = np.random.default_rng(3)
        a, b = rng.integers(0, ps.n, 400), rng.integers(0, ps.n, 400)
        out[f"b{bias}_pair_prob"], out[f"b{bias}_pair_dist"] = sc.score(a, b)
        # the same batch halved until each part holds at most SPLIT_BOUND
        # unique rows
        sc.MAX_PAIR_UNIQUE_ROWS = SPLIT_BOUND
        out[f"b{bias}_split_prob"], out[f"b{bias}_split_dist"] = sc.score(a, b)
        out[f"b{bias}_splits"] = np.array([sc.split_batches, sc.scored_pairs])
        del sc.MAX_PAIR_UNIQUE_ROWS
        out[f"b{bias}_all_prob"], out[f"b{bias}_all_dist"] = sc.score_center_all(3)
        eng = MeanShiftEngine(ps, model, w.id_cutoff, scorer=sc)
        cls = eng.run()
        out[f"b{bias}_clusters"] = clusters_array(cls)
        out[f"b{bias}_rechecked"] = np.array([sc.rechecked_pairs, sc.scored_pairs])


def clusters_array(clusters) -> np.ndarray:
    """The surviving clusters as one flat array: (center, size, sorted
    members...) per cluster, clusters sorted."""
    rows = sorted((c.center_row, tuple(sorted(c.members)))
                  for c in clusters if not getattr(c, "deleted", False))
    flat = []
    for center, members in rows:
        flat += [center, len(members), *members]
    return np.asarray(flat, dtype=np.int64)


def spawn(task: str, worlds, tmp_dir: str, timeout: float = 240.0) -> dict:
    """Run TASK in one gloo group of each size in `worlds`, all at once,
    each join bounded by `timeout` seconds; {world: [each rank's arrays]}."""
    import subprocess

    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["OMP_NUM_THREADS"] = "1"
    procs = []
    for world in worlds:
        init = os.path.join(tmp_dir, f"init_{task}_{world}")
        for rank in range(world):
            procs.append((world, subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), task, str(rank), str(world),
                 init, tmp_dir], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    try:
        logs = [p.communicate(timeout=timeout)[0] for _, p in procs]
    finally:
        for _, p in procs:
            p.kill()
    for (world, p), log in zip(procs, logs):
        assert p.returncode == 0, f"{task}, world {world}: rank exited {p.returncode}\n{log[-3000:]}"
    return {world: [dict(np.load(os.path.join(tmp_dir, f"{task}_{world}_{r}.npz")))
                    for r in range(world)] for world in worlds}


def main(argv) -> int:
    task, rank, world, init_file, out_dir = argv
    sys.path.insert(0, ROOT)
    import torch.distributed as dist

    from meshclust2_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=int(rank),
                            world_size=int(world))
    mesh = make_mesh("cpu")
    out: dict = {}
    {"mesh": mesh_task, "scorer": scorer_task}[task](mesh, out)
    np.savez(os.path.join(out_dir, f"{task}_{world}_{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
