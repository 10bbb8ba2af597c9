"""The port's twin of tests/test_single_file_parity.py: --single-file with
--no-train-list on the recover path (BASELINE config 4: joined
multi-contig assemblies, 50-N gaps, ten of the thirty files excluded from
training), --device cpu (the kernels' plain versions, the default path),
against the reference binary's CLSTR: the same 6 clusters with the same
members and centers.  Tolerance: exact."""
import os
from collections import Counter

from meshclust2_tpu_torch import cli as torch_cli
from meshclust2_tpu_torch.io.clstr import parse_clstr


def test_single_file_notrain_parity(fixtures_dir, tmp_path):
    base = os.path.join(fixtures_dir, "singlefile")
    files = sorted(
        os.path.join(base, "asm", f)
        for f in os.listdir(os.path.join(base, "asm"))
        if f.endswith(".fa")
    )
    assert len(files) == 30
    train_list = tmp_path / "train.txt"
    notrain_list = tmp_path / "no.txt"
    train_list.write_text("\n".join(files[:20]) + "\n")
    notrain_list.write_text("\n".join(files[20:]) + "\n")
    out = tmp_path / "out.clstr"
    res = torch_cli.run([
        "--recover", os.path.join(base, "sf_weights.txt"),
        "--single-file",
        "--list", str(train_list),
        "--no-train-list", str(notrain_list),
        "--output", str(out), "--device", "cpu",
    ])
    assert res.rc == 0
    ref = parse_clstr(os.path.join(base, "ref_sf_rec.clstr"))
    got = parse_clstr(str(out))

    def cents(cl):
        return Counter(
            (
                frozenset(m["header"] for m in c),
                tuple(sorted(m["header"] for m in c if m["center"])),
            )
            for c in cl
        )

    assert len(got) == len(ref) == 6
    assert cents(got) == cents(ref)
