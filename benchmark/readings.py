"""The readings that a cell's limits are set from, outside any timed run.

    python3 benchmark/readings.py --workload NAME --seeds 1,2,3 [--device cuda]

For each seed, each pool of the cell: one job of the
program, as the window runs it, held against the float64 reference (the
lower readings), and the control, the reference computed in float32, held
against the same reference (the upper readings).  One line of JSON a pool,
then a summary line with each number's largest program reading and
smallest control reading.
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def control_lines(found, path: str) -> None:
    """The lines a float32 search prints."""
    with open(path, "w") as f:
        for q, d, v, k in zip(found.query.tolist(), found.db.tolist(),
                              found.value.tolist(), found.kept.tolist()):
            if k and v > 0:
                f.write(f"{found.query_names[q]}\t{found.db_names[d]}\t{v:g}\n")


def readings(workload: str, seeds, device: str):
    import json
    import tempfile

    import numpy as np
    import torch

    import reference as R
    from harness import plan as P
    from harness.check import ref_rows, sum_gap
    from harness.jobs import run_job
    from harness.main import cache_env
    from harness.pools import write_pool
    from harness.sample import DecisionSample
    from reference import compare as C

    plan = P.load(workload)
    cache_env(plan.root)
    config, traffic = plan.config, plan.traffic
    weights = plan.path(config["weights"])
    dev = torch.device(device)
    n_seqs = (traffic["n_seqs"] // traffic["n_templates"]) * traffic["n_templates"]
    lows, highs = {}, {}
    with tempfile.TemporaryDirectory(prefix="mc2read-") as work, \
            open(os.path.join(work, "program.log"), "w") as log:
        for seed in seeds:
            for pool in range(traffic["pools"]):
                path = os.path.join(work, "pool.fasta")
                write_pool(path, seed, pool, traffic)
                out = os.path.join(work, "out")
                sample = DecisionSample(seed, **config.get("sample", {"every": 1, "pairs": 1}))
                sample.job = 0
                with sample.patched():
                    job = run_job(config, dict(device=device, weights=weights,
                                               pool=path, output=out),
                                  pool, n_seqs, log, keep_rows=True)
                if job.error:
                    raise RuntimeError(f"seed {seed} pool {pool}: {job.error}")
                if config["program"] == "cluster":
                    ref = R.cluster(path, weights, dev, **config["options"])
                    ctl = R.cluster(path, weights, dev, dtype=np.float32,
                                    **config["options"])
                    low = {"hist_off": C.hist_off(ref.headers, ref.counts,
                                                  job.headers, job.counts),
                           "clstr_off": C.clstr_off(ref.keys, job.output)}
                    high = {"hist_off": C.hist_off(ref.headers, ref.counts,
                                                   ctl.headers, ctl.counts),
                            "clstr_off": sum(ref.keys.get(h) != ctl.keys.get(h)
                                             for h in set(ref.keys) | set(ctl.keys))}
                    a, b, s = sample.by_job()[0]
                    rows, ok = ref_rows(ref, job.headers, a, b)
                    ra, rb = rows[a[ok]], rows[b[ok]]
                    low["glm_sum_gap"] = sum_gap(ref, job.headers, a, b, s)
                    high["glm_sum_gap"] = C.sum_gap(
                        ref.sums(ra, rb, np.float32).astype(np.float64), ref.sums(ra, rb))
                    low["sampled_pairs"] = high["sampled_pairs"] = int(ok.sum())
                else:
                    ref = R.search_all(path, path, weights, dev, **config["options"])
                    ctl = R.search_all(path, path, weights, dev, dtype=np.float32,
                                       **config["options"])
                    control_lines(ctl, out + "-control")
                    low = {"lines_off": C.lines_off(ref, job.output),
                           "positives_off": C.positives_off(
                               ref, int(job.counters["positives"]))}
                    high = {"lines_off": C.lines_off(ref, out + "-control"),
                            "positives_off": C.positives_off(ref, ctl.positives)}
                for k in low:
                    lows[k] = max(lows.get(k, 0), low[k])
                    highs[k] = min(highs.get(k, high[k]), high[k])
                print(json.dumps({"seed": seed, "pool": pool, "program": low,
                                  "control": high,
                                  "job_s": job.end - job.start}), flush=True)
                del ref, ctl, job
                if device == "cuda":
                    torch.cuda.empty_cache()
    print(json.dumps({"workload": workload, "seeds": list(seeds),
                      "lower": lows, "upper": highs}), flush=True)


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    a = p.parse_args()
    readings(a.workload, [int(s) for s in a.seeds.split(",")], a.device)
