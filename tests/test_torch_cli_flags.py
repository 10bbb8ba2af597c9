"""The port's clustering CLI flags that the JAX CLI takes (`-l/--list`,
`--no-train-list`, `-t/--threads`, `--checkpoint`, `--resume-cluster`),
held against the JAX CLI's `--device host` runs, in the manner of
tests/test_cli_flags.py and tests/test_checkpoint.py.  The port runs with
--device cpu on its default path (the kernels' plain versions)."""
import os
import shutil

import pytest
import torch

from meshclust2_tpu.cli import main as jax_main
from meshclust2_tpu_torch import cli as torch_cli
from meshclust2_tpu_torch.cluster import checkpoint as port_checkpoint

torch.set_num_threads(2)

DEVICE_SWITCHES = ("MC2_NO_DEVICE_LOOP", "MC2_NO_DEVICE_UPDATE_BATCH",
                   "MC2_NO_DEVICE_SESSION", "MC2_DEVICE_TRAIN")


@pytest.fixture
def host_env(monkeypatch):
    for k in DEVICE_SWITCHES:
        monkeypatch.delenv(k, raising=False)


def both(tmp_path, argv):
    """The JAX CLI's --device host run and the port's of argv (which names
    no output): the two output files."""
    outs = []
    for side in ("jax", "port"):
        out = tmp_path / f"{side}.clstr"
        args = [*argv, "--output", str(out)]
        if side == "jax":
            assert jax_main(["--device", "host", *args]) == 0
        else:
            assert torch_cli.run(["--device", "cpu", *args]).rc == 0
        outs.append(out)
    return outs


def halves(fixtures_dir, tmp_path):
    recs = open(os.path.join(fixtures_dir, "small.fasta")).read().split(">")
    recs = [">" + r for r in recs if r.strip()]
    train, no = tmp_path / "train.fasta", tmp_path / "no.fasta"
    train.write_text("".join(recs[:100]))
    no.write_text("".join(recs[100:]))
    lst = tmp_path / "no.txt"
    lst.write_text(f"{no}\n{no}\n{train}\n")   # a repeat, and a train file
    return str(train), str(lst)


def test_list(fixtures_dir, tmp_path, host_env):
    small = os.path.join(fixtures_dir, "small.fasta")
    lst = tmp_path / "files.txt"
    lst.write_text(f"{small}\n\n{small}\n")
    jax_out, port_out = both(tmp_path, [
        "--recover", os.path.join(fixtures_dir, "small_ref_weights.txt"),
        "--list", str(lst)])
    assert port_out.read_bytes() == jax_out.read_bytes()
    assert port_out.read_text().count(">Cluster") == 20


def test_no_train_list_clusters_every_file(fixtures_dir, tmp_path, host_env):
    train, lst = halves(fixtures_dir, tmp_path)
    jax_out, port_out = both(tmp_path, [
        "--recover", os.path.join(fixtures_dir, "small_ref_weights.txt"),
        "--no-train-list", lst, train])
    assert port_out.read_bytes() == jax_out.read_bytes()
    assert port_out.read_text().count("nt, >") == 200


def test_no_train_list_leaves_training(fixtures_dir, tmp_path, host_env):
    """Training sees the train files only: the same weights as the JAX
    CLI's --device host training."""
    train, lst = halves(fixtures_dir, tmp_path)
    flags = ["--id", "0.9", "--kmer", "5", "--mut-type", "single",
             "--no-train-list", lst, train]
    assert jax_main(["--device", "host", "--dump", str(tmp_path / "jax_w.txt"),
                     *flags]) == 0
    res = torch_cli.run(["--device", "cpu", "--dump",
                         str(tmp_path / "port_w.txt"), *flags])
    assert res.rc == 0 and res.trained is not None
    assert (tmp_path / "port_w.txt").read_bytes() == \
        (tmp_path / "jax_w.txt").read_bytes()


def test_threads(fixtures_dir, tmp_path, host_env):
    from meshclust2_tpu_torch.native import set_num_threads

    try:
        jax_out, port_out = both(tmp_path, [
            "--recover", os.path.join(fixtures_dir, "small_ref_weights.txt"),
            "--threads", "1", os.path.join(fixtures_dir, "small.fasta")])
    finally:
        set_num_threads(os.cpu_count())
    assert port_out.read_bytes() == jax_out.read_bytes()
    assert torch_cli.build_parser().parse_args(["-t", "3", "x"]).threads == 3


def test_parser_takes_the_jax_flags():
    args = torch_cli.build_parser().parse_args(
        ["-l", "a.txt", "--notrain-list", "b.txt", "--checkpoint", "c.npz",
         "--resume-cluster", "d.npz", "x.fasta"])
    assert (args.list_file, args.notrain_list, args.checkpoint,
            args.resume_cluster, args.threads) == ("a.txt", "b.txt", "c.npz",
                                                   "d.npz", 0)


# the med2000 default path's checkpoints: after the accumulate phase, then
# after each of its 6 update iterations
CHECKPOINTS = ["accumulated0"] + [f"update{i}" for i in range(1, 7)]


@pytest.fixture(scope="module")
def med_checkpoints(fixtures_dir, tmp_path_factory):
    """One --checkpoint run of med2000 on the default path with a copy of
    every checkpoint it wrote, its CLSTR, and the JAX CLI's --device host
    CLSTR of the same run."""
    tmp = tmp_path_factory.mktemp("ck")
    mp = pytest.MonkeyPatch()
    for k in DEVICE_SWITCHES:
        mp.delenv(k, raising=False)
    real = port_checkpoint.save_checkpoint
    written = []

    def keep_each(path, clusters, *, phase, iteration, **kw):
        real(path, clusters, phase=phase, iteration=iteration, **kw)
        copy = tmp / f"{phase}{iteration}.npz"
        shutil.copy(path, copy)
        written.append(copy.stem)

    mp.setattr(port_checkpoint, "save_checkpoint", keep_each)
    weights = os.path.join(fixtures_dir, "med2000_weights.txt")
    fasta = os.path.join(fixtures_dir, "med2000.fasta")
    try:
        res = torch_cli.run(["--device", "cpu", "--recover", weights,
                             "--output", str(tmp / "full.clstr"),
                             "--checkpoint", str(tmp / "state.npz"), fasta])
    finally:
        mp.undo()
    assert res.rc == 0 and res.accumulator is not None
    assert res.engine.stats.update_iterations == 6
    assert jax_main(["--device", "host", "--recover", weights, "--output",
                     str(tmp / "jax.clstr"), fasta]) == 0
    return tmp, weights, fasta, written


def test_checkpoint_run_equals_jax_host(med_checkpoints):
    tmp, _, _, written = med_checkpoints
    assert written == CHECKPOINTS
    assert (tmp / "full.clstr").read_bytes() == (tmp / "jax.clstr").read_bytes()


@pytest.mark.parametrize("name", CHECKPOINTS)
def test_resume_from_checkpoint(med_checkpoints, tmp_path, host_env, name):
    tmp, weights, fasta, _ = med_checkpoints
    out = tmp_path / "resumed.clstr"
    res = torch_cli.run(["--device", "cpu", "--recover", weights, "--output",
                         str(out), "--resume-cluster", str(tmp / f"{name}.npz"),
                         fasta])
    assert res.rc == 0
    assert out.read_bytes() == (tmp / "full.clstr").read_bytes()


def test_checkpoint_of_another_dataset_is_refused(fixtures_dir, tmp_path,
                                                  med_checkpoints, host_env):
    ck = tmp_path / "small.npz"
    assert torch_cli.run([
        "--device", "cpu", "--recover",
        os.path.join(fixtures_dir, "small_ref_weights.txt"), "--output",
        str(tmp_path / "small.clstr"), "--checkpoint", str(ck),
        os.path.join(fixtures_dir, "small.fasta")]).rc == 0
    _, weights, fasta, _ = med_checkpoints
    with pytest.raises(ValueError, match="different dataset"):
        torch_cli.run(["--device", "cpu", "--recover", weights, "--output",
                       str(tmp_path / "o.clstr"), "--resume-cluster", str(ck),
                       fasta])
