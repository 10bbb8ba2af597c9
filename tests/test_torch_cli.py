"""The port's recover-path CLI with --device cpu (the kernels' plain
versions) against the JAX package and the reference goldens."""
import gzip
import os
import shutil

import pytest
import torch

from meshclust2_tpu.io.clstr import parse_clstr
from meshclust2_tpu_torch import cli as torch_cli
from tests.test_cluster_parity import cluster_signature

torch.set_num_threads(2)

# the JAX package's device-scorer configuration of the recover path: every
# batch through DeviceScorer (the Pallas kernel in interpret mode on CPU)
JAX_REFERENCE_ENV = {
    "MC2_NO_DEVICE_SESSION": "1",
    "MC2_NO_DEVICE_LOOP": "1",
    "MC2_NO_DEVICE_UPDATE_BATCH": "1",
    "MC2_DEVICE_THRESHOLD": "0",
    "MC2_DEVICE_PROBE_TIMEOUT": "0",
    # set by the JAX CLI itself for --device tpu; pinned here so that
    # monkeypatch restores the environment afterwards
    "MC2_DEVICE_TRAIN": "1",
}


def port_run(fixtures_dir, tmp_path, fasta, weights, device="cpu"):
    out = tmp_path / f"port_{os.path.basename(fasta)}.clstr"
    res = torch_cli.run([
        "--device", device,
        "--recover", os.path.join(fixtures_dir, weights),
        "--output", str(out),
        os.path.join(fixtures_dir, fasta),
    ])
    assert res.rc == 0
    return out, res


def test_small_equals_jax_reference_configuration(fixtures_dir, tmp_path,
                                                  monkeypatch):
    from meshclust2_tpu.cli import main as jax_main

    out, res = port_run(fixtures_dir, tmp_path, "small.fasta",
                        "small_ref_weights.txt")
    for k, v in JAX_REFERENCE_ENV.items():
        monkeypatch.setenv(k, v)
    jax_out = tmp_path / "jax.clstr"
    assert jax_main([
        "--device", "tpu",
        "--recover", os.path.join(fixtures_dir, "small_ref_weights.txt"),
        "--output", str(jax_out),
        os.path.join(fixtures_dir, "small.fasta"),
    ]) == 0
    assert out.read_bytes() == jax_out.read_bytes()
    ref = parse_clstr(os.path.join(fixtures_dir, "small_ref.clstr"))
    assert cluster_signature(parse_clstr(str(out))) == cluster_signature(ref)
    assert res.scorer.scored_pairs == res.engine.stats.pairs_scored


def test_med2000_equals_reference(fixtures_dir, tmp_path):
    out, res = port_run(fixtures_dir, tmp_path, "med2000.fasta",
                        "med2000_weights.txt")
    with open(os.path.join(fixtures_dir, "med2000_ref.clstr")) as f:
        want = sorted(f.readlines())
    with open(out) as f:
        assert sorted(f.readlines()) == want
    s = res.engine.stats
    assert (s.windows_scored, s.pairs_scored, s.clusters_before_update,
            s.update_iterations) == (146, 62_376, 305, 6)
    assert res.scorer.scored_pairs == 62_376


@pytest.mark.slow
def test_bench10k_equals_reference(fixtures_dir, tmp_path):
    import bench
    from tests.test_parity_10k import _signature

    fasta = tmp_path / "bench_10000.fasta"
    assert bench.N_SEQS == 10000 and bench.SEED == 424242
    bench.ensure_dataset(str(fasta))
    out, res = port_run(fixtures_dir, tmp_path, str(fasta),
                        "bench10k_weights.txt")
    ref_txt = tmp_path / "ref.clstr"
    with gzip.open(os.path.join(fixtures_dir, "bench10k_ref_t1.clstr.gz"),
                   "rb") as f, open(ref_txt, "wb") as g:
        shutil.copyfileobj(f, g)
    got = parse_clstr(str(out))
    assert len(got) == 788
    assert _signature(got) == _signature(parse_clstr(str(ref_txt)))
    s = res.engine.stats
    assert (s.windows_scored, s.pairs_scored, s.clusters_before_update,
            s.update_iterations) == (590, 789_698, 1_147, 7)


def test_device_cuda_raises_without_gpu(fixtures_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_run(fixtures_dir, tmp_path, "small.fasta",
                 "small_ref_weights.txt", device="cuda")


def test_without_recover_exits_nonzero(fixtures_dir, capsys):
    rc = torch_cli.main(["--device", "cpu",
                         os.path.join(fixtures_dir, "small.fasta")])
    assert rc != 0
    assert "--recover" in capsys.readouterr().err
