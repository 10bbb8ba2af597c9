"""The port's recover-path CLI with --device cpu (the kernels' plain
versions) against the JAX package and the reference goldens, on its three
paths: the default (TorchDeviceAccumulator, then TorchDevicePhaseUpdater);
MC2_NO_DEVICE_LOOP=1 (the accumulate windows through TorchDeviceScorer, the
update phase through the updater); and MC2_NO_DEVICE_LOOP=1
MC2_NO_DEVICE_UPDATE_BATCH=1 (both phases through the scorer).  The tests
that pin MC2_NO_DEVICE_LOOP=1 keep the counters of those two paths.  Pools
the kernels do not take (uint32, or outside the exact-integer envelope) go
to the host scorer and host training tables, against the JAX CLI's
--device host."""
import gzip
import os
import shutil

import pytest
import torch

from meshclust2_tpu.io.clstr import parse_clstr
from meshclust2_tpu_torch import cli as torch_cli

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


def counters(res):
    s = res.engine.stats
    return (s.windows_scored, s.pairs_scored, s.clusters_before_update,
            s.update_iterations)


def jax_run(fixtures_dir, tmp_path, monkeypatch, update_batch,
            device_loop=False):
    """The JAX package on the small fixture in the sessionless device
    configuration: with update_batch, the update phase goes through its
    DeviceUpdater; without, through DeviceScorer.  With device_loop, the
    accumulate phase goes through its DeviceAccumulator."""
    from meshclust2_tpu.cli import main as jax_main

    for k, v in JAX_REFERENCE_ENV.items():
        monkeypatch.setenv(k, v)
    if update_batch:
        monkeypatch.delenv("MC2_NO_DEVICE_UPDATE_BATCH")
    if device_loop:
        monkeypatch.delenv("MC2_NO_DEVICE_LOOP")
    jax_out = tmp_path / "jax.clstr"
    assert jax_main([
        "--device", "tpu",
        "--recover", os.path.join(fixtures_dir, "small_ref_weights.txt"),
        "--output", str(jax_out),
        os.path.join(fixtures_dir, "small.fasta"),
    ]) == 0
    return jax_out


def test_small_equals_jax_reference_configuration(fixtures_dir, tmp_path,
                                                  monkeypatch):
    # imported here, not at the top: the card's machine may hold another
    # top-level `tests` package, and its cuda-marked run collects this file
    from tests.test_cluster_parity import cluster_signature

    monkeypatch.setenv("MC2_NO_DEVICE_LOOP", "1")
    monkeypatch.setenv("MC2_NO_DEVICE_UPDATE_BATCH", "1")
    out, res = port_run(fixtures_dir, tmp_path, "small.fasta",
                        "small_ref_weights.txt")
    assert res.updater is None
    jax_out = jax_run(fixtures_dir, tmp_path, monkeypatch, update_batch=False)
    assert out.read_bytes() == jax_out.read_bytes()
    ref = parse_clstr(os.path.join(fixtures_dir, "small_ref.clstr"))
    assert cluster_signature(parse_clstr(str(out))) == cluster_signature(ref)
    assert res.scorer.scored_pairs == res.engine.stats.pairs_scored


def test_small_default_path_equals_jax_updater_configuration(
        fixtures_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("MC2_NO_DEVICE_LOOP", "1")
    monkeypatch.delenv("MC2_NO_DEVICE_UPDATE_BATCH", raising=False)
    out, res = port_run(fixtures_dir, tmp_path, "small.fasta",
                        "small_ref_weights.txt")
    assert res.accumulator is None
    jax_out = jax_run(fixtures_dir, tmp_path, monkeypatch, update_batch=True)
    assert out.read_bytes() == jax_out.read_bytes()
    assert counters(res) == (38, 6_977, 21, 3)
    # accumulate windows through the scorer, every update pair through the
    # updater
    assert res.updater.scored_pairs == 5_085
    assert res.scorer.scored_pairs + res.updater.scored_pairs == 6_977


def test_med2000_equals_reference(fixtures_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("MC2_NO_DEVICE_LOOP", "1")
    monkeypatch.setenv("MC2_NO_DEVICE_UPDATE_BATCH", "1")
    out, res = port_run(fixtures_dir, tmp_path, "med2000.fasta",
                        "med2000_weights.txt")
    with open(os.path.join(fixtures_dir, "med2000_ref.clstr")) as f:
        want = sorted(f.readlines())
    with open(out) as f:
        assert sorted(f.readlines()) == want
    assert counters(res) == (146, 62_376, 305, 6)
    assert res.scorer.scored_pairs == 62_376


@pytest.mark.parametrize("margin", [None, "3e-3"])
def test_med2000_default_path_equals_reference(fixtures_dir, tmp_path,
                                               monkeypatch, margin):
    """The default path: updater pairs as in the JAX updater configuration.
    A forced decision margin (MC2_DD_MARGIN, read by resolve_margins) sends
    pairs to the host re-check without changing the result."""
    monkeypatch.setenv("MC2_NO_DEVICE_LOOP", "1")
    monkeypatch.delenv("MC2_NO_DEVICE_UPDATE_BATCH", raising=False)
    if margin is not None:
        monkeypatch.setenv("MC2_DD_MARGIN", margin)
    out, res = port_run(fixtures_dir, tmp_path, "med2000.fasta",
                        "med2000_weights.txt")
    with open(os.path.join(fixtures_dir, "med2000_ref.clstr")) as f:
        want = sorted(f.readlines())
    with open(out) as f:
        assert sorted(f.readlines()) == want
    assert counters(res) == (146, 152_619, 305, 6)
    assert res.updater.scored_pairs == 116_481
    if margin is not None:
        assert res.updater.margin == float(margin)
        assert res.updater.rechecked_pairs > 0


def bench10k_run(fixtures_dir, tmp_path):
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
    return res


@pytest.mark.slow
def test_bench10k_equals_reference(fixtures_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("MC2_NO_DEVICE_LOOP", "1")
    monkeypatch.setenv("MC2_NO_DEVICE_UPDATE_BATCH", "1")
    res = bench10k_run(fixtures_dir, tmp_path)
    assert counters(res) == (590, 789_698, 1_147, 7)


@pytest.mark.slow
def test_bench10k_default_path_equals_reference(fixtures_dir, tmp_path,
                                                monkeypatch):
    monkeypatch.setenv("MC2_NO_DEVICE_LOOP", "1")
    monkeypatch.delenv("MC2_NO_DEVICE_UPDATE_BATCH", raising=False)
    res = bench10k_run(fixtures_dir, tmp_path)
    assert counters(res) == (590, 1_386_736, 1_147, 7)
    assert res.updater.scored_pairs == 708_385


def test_small_device_loop_path_equals_jax_device_loop_configuration(
        fixtures_dir, tmp_path, monkeypatch):
    """The default path: the accumulate phase through TorchDeviceAccumulator
    and the update phase through TorchDevicePhaseUpdater, against the JAX
    package's DeviceAccumulator and DeviceUpdater in its sessionless device
    configuration: the same bytes and the same engine counters."""
    for k in ("MC2_NO_DEVICE_LOOP", "MC2_NO_DEVICE_UPDATE_BATCH"):
        monkeypatch.delenv(k, raising=False)
    out, res = port_run(fixtures_dir, tmp_path, "small.fasta",
                        "small_ref_weights.txt")
    assert res.accumulator is not None and res.accumulator.total_steps > 0
    jax_out = jax_run(fixtures_dir, tmp_path, monkeypatch, update_batch=True,
                      device_loop=True)
    assert out.read_bytes() == jax_out.read_bytes()
    assert counters(res) == (38, 6_977, 21, 3)
    assert res.accumulator.last_pairs + res.phase.scored_pairs == 6_977
    assert res.updater.scored_pairs == 0 and res.scorer.scored_pairs == 0


def test_med2000_without_update_batch_on_the_device_loop(fixtures_dir,
                                                         tmp_path, monkeypatch):
    """The device loop with MC2_NO_DEVICE_UPDATE_BATCH=1: the update phase
    through the scorer and the engine's memo, the accumulate phase still on
    the accumulator."""
    monkeypatch.delenv("MC2_NO_DEVICE_LOOP", raising=False)
    monkeypatch.setenv("MC2_NO_DEVICE_UPDATE_BATCH", "1")
    out, res = port_run(fixtures_dir, tmp_path, "med2000.fasta",
                        "med2000_weights.txt")
    with open(os.path.join(fixtures_dir, "med2000_ref.clstr")) as f:
        want = sorted(f.readlines())
    with open(out) as f:
        assert sorted(f.readlines()) == want
    assert res.updater is None and res.accumulator.last_pairs == 48_737
    assert counters(res) == (146, 48_737 + res.scorer.scored_pairs, 305, 6)


def test_accumulator_failure_exits_nonzero(fixtures_dir, tmp_path, monkeypatch,
                                           capsys):
    """The engine catches any error of the device accumulate loop and
    finishes on the host; the CLI raises it again afterwards, so a failure
    of the device path cannot pass as a success."""
    from meshclust2_tpu_torch.cluster import device_loop

    def broken(*args, **kw):
        raise RuntimeError("injected window_step failure")

    for k in ("MC2_NO_DEVICE_LOOP", "MC2_NO_DEVICE_UPDATE_BATCH"):
        monkeypatch.delenv(k, raising=False)
    real = device_loop.window_step
    calls = []

    def fail_after_warm_up(*args, **kw):
        calls.append(1)
        return (broken if len(calls) > 1 else real)(*args, **kw)

    monkeypatch.setattr(device_loop, "window_step", fail_after_warm_up)
    with pytest.raises(RuntimeError, match="device accumulate loop failed") as e:
        torch_cli.main(["--device", "cpu", "--recover",
                        os.path.join(fixtures_dir, "small_ref_weights.txt"),
                        "--output", str(tmp_path / "out.clstr"),
                        os.path.join(fixtures_dir, "small.fasta")])
    assert "injected" in str(e.value.__cause__)
    assert "falling back to the host paths" in capsys.readouterr().out


def test_device_cuda_raises_without_gpu(fixtures_dir, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_run(fixtures_dir, tmp_path, "small.fasta",
                 "small_ref_weights.txt", device="cuda")


def _host_reference(tmp_path, monkeypatch, argv):
    """The JAX CLI's --device host run of argv (its native host scorer)."""
    from meshclust2_tpu.cli import main as jax_main

    for k in JAX_REFERENCE_ENV:
        monkeypatch.delenv(k, raising=False)
    assert jax_main(["--device", "host", *argv]) == 0


@pytest.mark.parametrize("pool", ["uint32", "envelope"])
def test_pool_the_kernels_do_not_take_clusters_on_the_host(
        fixtures_dir, tmp_path, monkeypatch, capsys, pool):
    """A uint32 pool, and a uint16 pool whose homopolymer row puts the dot
    product past 2^31: no device session; the engine copy on the native
    host scorer gives the JAX CLI's --device host CLSTR byte for byte, and
    stderr names the reason."""
    src = os.path.join(fixtures_dir, "small.fasta")
    with open(os.path.join(fixtures_dir, "small_ref_weights.txt")) as f:
        weights = f.read()
    if pool == "uint32":
        fasta = src
        weights = weights.replace("Datatype: uint8_t", "Datatype: uint32_t")
        reason = "uint32 histograms"
    else:
        fasta = str(tmp_path / "poly_a.fasta")
        poly = "A" * 47_000
        with open(src) as f, open(fasta, "w") as g:
            g.write(f.read())
            g.write(">poly_a\n" + "\n".join(poly[i:i + 80] for i in
                                           range(0, len(poly), 80)) + "\n")
        weights = weights.replace("Datatype: uint8_t", "Datatype: uint16_t")
        reason = "dot product >= 2^31"
    w = tmp_path / "weights.txt"
    w.write_text(weights)
    out = tmp_path / "port.clstr"
    res = torch_cli.run(["--device", "cpu", "--recover", str(w), "--output",
                         str(out), fasta])
    err = capsys.readouterr().err
    assert res.rc == 0
    assert f"meshclust2-torch: {reason}" in err and "host scorer" in err
    assert res.accumulator is None and res.updater is None
    assert type(res.scorer).__name__ == "NativeScorer"
    jax_out = tmp_path / "jax.clstr"
    _host_reference(tmp_path, monkeypatch, ["--recover", str(w), "--output",
                                            str(jax_out), fasta])
    assert out.read_bytes() == jax_out.read_bytes()
    if pool == "envelope":
        assert "poly_a" in out.read_text()


def test_training_on_a_uint32_pool_builds_host_tables(fixtures_dir, tmp_path,
                                                     monkeypatch, capsys):
    """--datatype 32 without --recover: the training tables come from the
    host oracle, and the weights equal the JAX CLI's --device host
    training byte for byte."""
    flags = ["--datatype", "32", "--id", "0.9", "--kmer", "5", "--mut-type",
             "single", os.path.join(fixtures_dir, "small.fasta")]
    port_w, jax_w = tmp_path / "port_w.txt", tmp_path / "jax_w.txt"
    res = torch_cli.run(["--device", "cpu", "--dump", str(port_w), *flags])
    assert res.rc == 0
    assert "uint32 histograms" in capsys.readouterr().err
    assert res.tables.tables == 0
    _host_reference(tmp_path, monkeypatch, ["--dump", str(jax_w), *flags])
    assert port_w.read_bytes() == jax_w.read_bytes()
