#!/usr/bin/env python3
"""The port's clustering window in two checkouts of the repository, on one
card, in turns.

    python3 ab_paths.py BEFORE_ROOT AFTER_ROOT [--out DIR] [--paths P,..]
                        [--order before,after,...] [--ranks N]

Makes the bench set (bench.py:ensure_dataset: 10,000 sequences, or
BENCH_N_SEQS), then, for each of the port's three paths (the default,
MC2_NO_DEVICE_LOOP=1, and with MC2_NO_DEVICE_UPDATE_BATCH=1 as well; or
those named by --paths, among them device_count: the default path with its
counts built on the card, MC2_DEVICE_COUNT=1; multihost_session:
--multihost as a one-rank NCCL group, the device session over the
row-sharded store; multihost: the same per-window, MC2_NO_DEVICE_SESSION=1),
runs `python -m meshclust2_tpu_torch.cli --device
cuda --recover tests/fixtures/bench10k_weights.txt` from each checkout's
root in the order before, after, after, before (or --order).  Each run is a
process of its own (with --ranks N the --multihost paths run N processes,
one a card, MC2_NPROCS=N, and rank 0's stamps are the run's); its kernels
build in its checkout's build/ during set-up, before the window.  Prints one line a run with its set-up (the
`read_in_points` stamp), the window (the `done` stamp less
`read_in_points`) and its accumulate and update parts,
then per path and checkout the median window and update part, and checks
that every run of a path wrote the same CLSTR byte for byte.  Exits
non-zero on a failed run or a differing CLSTR.
"""
from __future__ import annotations

import argparse
import os
import re
import socket
import statistics
import subprocess
import sys

import bench

ROOT = os.path.dirname(os.path.abspath(__file__))
PATHS = {
    "default": {},
    "no_device_loop": {"MC2_NO_DEVICE_LOOP": "1"},
    "no_device_loop_no_update_batch": {"MC2_NO_DEVICE_LOOP": "1",
                                       "MC2_NO_DEVICE_UPDATE_BATCH": "1"},
    "device_count": {"MC2_DEVICE_COUNT": "1"},
    "multihost_session": {},
    "multihost": {"MC2_NO_DEVICE_SESSION": "1"},
}
# the paths that run the CLI's --multihost
MULTIHOST = ("multihost_session", "multihost")
DEFAULT_PATHS = "default,no_device_loop,no_device_loop_no_update_batch"
ORDER = "before,after,after,before"


def stamps(text: str) -> dict:
    return {m.group(1): float(m.group(2)) for m in re.finditer(
        r"^timestamp (\S+) (\S+)$", text, re.M)}


def one_run(root: str, path: str, fasta: str, out: str, ranks: int = 1) -> dict:
    """One CLI run of checkout `root` on `path` -> its window parts (s);
    a --multihost path on `ranks` processes, rank 0's, with its session
    line (MC2_DEVICE_PROF)."""
    env = {k: v for k, v in os.environ.items() if k not in
           ("MC2_NO_DEVICE_LOOP", "MC2_NO_DEVICE_UPDATE_BATCH", "MC2_DEVICE_COUNT",
            "MC2_NO_DEVICE_SESSION", "MC2_NPROCS")}
    env.update(PATHS[path])
    cmd = ([sys.executable, "-m", "meshclust2_tpu_torch.cli", "--device", "cuda"]
           + (["--multihost"] if path in MULTIHOST else []) + [
           "--recover", os.path.join(root, "tests", "fixtures", "bench10k_weights.txt"),
           "--output", out, fasta])
    n = ranks if path in MULTIHOST else 1
    if n > 1:
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        envs = [dict(env, MC2_NPROCS=str(n), MC2_PROC_ID=str(i), MC2_DEVICE_PROF="1",
                     MC2_COORD=f"localhost:{port}") for i in range(n)]
    else:
        envs = [env]
    procs = [subprocess.Popen(cmd, cwd=root, env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for e in envs]
    try:
        got = [p.communicate(timeout=1800) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, got):
        if p.returncode != 0:
            raise RuntimeError(f"{root} ({path}) exited {p.returncode}:\n{err[-2000:]}")
    st = stamps(got[0][0])
    line = re.search(r"block mode: [^\n]*", got[0][0])
    return dict(setup=st["read_in_points"], window=st["done"] - st["read_in_points"],
                accumulate=st["accumulate"] - st["read_in_points"],
                update=st["update"] - st["accumulate"],
                session=line.group(0) if line else "")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("before")
    ap.add_argument("after")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "ab"))
    ap.add_argument("--paths", default=DEFAULT_PATHS)
    ap.add_argument("--order", default=ORDER)
    ap.add_argument("--ranks", type=int, default=1,
                    help="processes of the --multihost paths, one a card")
    args = ap.parse_args(argv)
    order = args.order.split(",")
    if not set(order) <= {"before", "after"}:
        raise SystemExit(f"--order takes before and after, got {args.order}")
    roots = {"before": os.path.abspath(args.before),
             "after": os.path.abspath(args.after)}
    args.out = os.path.abspath(args.out)   # each run's cwd is its checkout
    os.makedirs(args.out, exist_ok=True)
    fasta = os.path.join(args.out, f"bench_{bench.N_SEQS}.fasta")
    bench.ensure_dataset(fasta)
    ok = True
    for path in args.paths.split(","):
        windows = {"before": [], "after": []}
        updates = {"before": [], "after": []}
        outputs = []
        for i, which in enumerate(order):
            out = os.path.join(args.out, f"{path}_{i}_{which}.clstr")
            r = one_run(roots[which], path, fasta, out, args.ranks)
            windows[which].append(r["window"])
            updates[which].append(r["update"])
            with open(out, "rb") as f:
                outputs.append(f.read())
            print(f"{path} {which}: set-up {r['setup']:.3f} s, window "
                  f"{r['window']:.3f} s (accumulate "
                  f"{r['accumulate']:.3f} s, update {r['update']:.3f} s)"
                  + (f"; rank 0's {r['session']}" if r["session"] else ""), flush=True)
        same = all(o == outputs[0] for o in outputs)
        ok &= same
        med = {k: (statistics.median(windows[k]), statistics.median(updates[k]))
               for k in windows if windows[k]}
        print(f"{path}, {bench.N_SEQS} sequences: median window (update part) "
              + ", ".join(f"{k} {w:.3f} s ({u:.3f} s)" for k, (w, u) in med.items())
              + f"; CLSTR {'identical' if same else 'DIFFERS'} across the "
              f"{len(order)} runs", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
