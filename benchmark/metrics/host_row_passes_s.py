"""A clustering job's host passes over its whole N x 4^k histogram matrix
beside the counting: build_point_set's per-row magnitudes and stddevs (the
span `setup.moments`) and each check of the exact-integer envelope, an
int64 copy of the matrix and its self dots (`session.envelope`, once for
the store's refusal and once for its upload on the recover path); the two
summed a job, the mean over the window's jobs.  A program without these
spans gives no reading."""
from metrics._jobs import cluster_jobs
from metrics._spans import job_records, total_s

NAMES = ("setup.moments", "session.envelope")


def read(run):
    pairs = job_records(cluster_jobs(run))
    if not any(n in r.spans for _, recs in pairs for r in recs for n in NAMES):
        return None
    return sum(total_s(recs, NAMES) for _, recs in pairs) / len(pairs)
