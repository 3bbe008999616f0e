"""The rest of the port's ``classify`` surface against the JAX package's
CLI on the CPU: DAZZ ``.dam`` input with ``-s`` (the ``.class`` file and
the ``.class``/``.rep`` tracks), ``-s`` on FASTX (``.seeds``/``.rep``),
``--stats-json``, and the C++ seed selection (``NativeSeedWorkspace``)
against the JAX package's Python ``seeds.find_seeds``.  Every comparison
is byte equality; the committed tests/fixtures/tiny/dam tracks and the
tiny goldens are the reference's bytes.
"""
import gzip
import json
import pathlib
import shutil

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

FIX = pathlib.Path(__file__).parent / "fixtures"
TINY = FIX / "tiny"
DAM = TINY / "dam"
DB_FILES = ("reads.dam", ".reads.idx", ".reads.bps", ".reads.hdr")
TRACKS = (".reads.class.anno", ".reads.class.data", ".reads.rep.anno",
          ".reads.rep.data")
GOLD = gzip.decompress((TINY / "golden.class.gz").read_bytes())


def _copy_db(d: pathlib.Path) -> str:
    d.mkdir()
    for fn in DB_FILES:
        shutil.copy(DAM / fn, d / fn)
    return str(d / "reads.dam")


def _port(args):
    from classpro_tpu_torch.cli import main

    return main(["classify"] + args + ["-N", str(TINY / "reads"),
                                       "--device", "cpu", "-T", "2"])


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX CLI's -s runs: on a copy of the .dam, and on FASTX with
    --stats-json."""
    from classpro_tpu.cli import main as jax_main

    d = tmp_path_factory.mktemp("jax")
    dam = _copy_db(d / "dam")
    assert jax_main(["classify", "-s", dam, "-N", str(TINY / "reads"),
                     "-T", "2"]) == 0
    out = str(d / "fx.class")
    assert jax_main(["classify", "-s", str(TINY / "reads.fasta.gz"), "-N",
                     str(TINY / "reads"), "-o", out, "-T", "2",
                     "--stats-json", str(d / "stats.json")]) == 0
    return d


def test_dam_seeds_equal_jax_and_fixture(jax_runs, tmp_path):
    dam = _copy_db(tmp_path / "dam")
    assert _port(["-s", dam]) == 0
    got = tmp_path / "dam"
    assert (got / "reads.class").read_bytes() == \
        (jax_runs / "dam" / "reads.class").read_bytes() == GOLD
    for fn in TRACKS:
        assert (got / fn).read_bytes() == \
            (jax_runs / "dam" / fn).read_bytes() == (DAM / fn).read_bytes(), fn


def test_dam_without_seeds_writes_class_track(tmp_path):
    """Without -s the .class track holds the classes themselves (2-bit
    codes in const.c's E,R,H,D order) and the .rep track no interval."""
    from classpro_tpu_torch.io.dazz import compress_codes, read_track

    dam = _copy_db(tmp_path / "dam")
    assert _port([dam[:-len(".dam")]]) == 0     # probed as root + .dam
    root = str(tmp_path / "dam" / "reads")
    assert pathlib.Path(root + ".class").read_bytes() == GOLD
    ctos = np.zeros(256, np.uint8)
    for code, ch in enumerate(b"ERHD"):
        ctos[ch] = code
    classes = GOLD.decode().split("\n")[3::4]
    size, offs, data = read_track(root, "class")
    assert size == 8 and len(offs) == len(classes) + 1
    want = [compress_codes(ctos[np.frombuffer(c.encode(), np.uint8)])
            for c in classes]
    assert data == b"".join(want)
    size, offs, data = read_track(root, "rep")
    assert size == 0 and not offs.any() and data == b""


def test_fastx_seeds_equal_jax(jax_runs, tmp_path):
    out = tmp_path / "fx.class"
    stats = tmp_path / "stats.json"
    assert _port(["-s", str(TINY / "reads.fasta.gz"), "-o", str(out),
                  "--stats-json", str(stats)]) == 0
    assert out.read_bytes() == GOLD
    for ext in (".seeds", ".rep"):
        assert pathlib.Path(str(out) + ext).read_bytes() == \
            pathlib.Path(str(jax_runs / "fx.class") + ext).read_bytes()
    # the labels are the reference's seed selection (golden.seeds.gz)
    K = 40
    lines = pathlib.Path(str(out) + ".seeds").read_text().splitlines()
    with gzip.open(TINY / "golden.seeds.gz", "rt") as f:
        gold = f.read().splitlines()
    assert [s[K - 1:] for s in lines[1::2]][:len(gold)] == gold
    # --stats-json: the JAX engine's keys, the same counts (the JAX
    # engine absorbs chunks into shapes warmed by earlier runs in the
    # process; the port has no absorption)
    got = json.loads(stats.read_text())
    want = json.loads((jax_runs / "stats.json").read_text())
    assert set(got) == set(want)
    for k in ("reads", "kmers", "guard_flagged"):
        assert got[k] == want[k], k
    assert got["absorbed_chunks"] == 0 and got["chunks"] >= 2


def test_native_seed_workspace_matches_jax_seeds():
    """The port's C++ seed selection == the JAX package's Python oracle,
    labels and repeat intervals, over the tiny reads with ONE workspace
    each (the stale-slot state carried across reads must match too)."""
    from classpro_tpu.seeds import Workspace, find_seeds

    from classpro_tpu_torch.io.fastk import open_profiles
    from classpro_tpu_torch.native import NativeSeedWorkspace

    P = open_profiles(str(TINY / "reads"))
    K = P.kmer
    text = GOLD.decode().split("\n")
    seqs, classes = text[1::4], text[3::4]
    ws_py, ws_c = Workspace(), NativeSeedWorkspace()
    for rid in range(P.nreads):
        prof = P.fetch(rid)
        got = ws_c.find_seeds(seqs[rid], classes[rid][K - 1:], prof, K)
        want = find_seeds(seqs[rid], classes[rid][K - 1:], prof, K, ws_py)
        assert got == want, f"read {rid}"
    assert ws_c.find_seeds("ACGT", "", np.zeros(0, np.uint16), K) == ("", [])
    ws_c.close()
    ws_c.close()


def test_refusals(tmp_path, capsys):
    """--server names its later slice; an unopenable input gets the
    reference's message; --devices on the CPU is refused."""
    from classpro_tpu_torch.cli import main

    assert main(["classify", str(TINY / "reads.fasta.gz"), "--server",
                 str(tmp_path / "sock")]) == 1
    assert "later slice" in capsys.readouterr().err
    assert main(["classify", str(tmp_path / "nothing")]) == 1
    assert "as a .db|.dam or .f{ast}[aq][.gz] file" in \
        capsys.readouterr().err
    assert _port([str(TINY / "reads.fasta.gz"), "-o",
                  str(tmp_path / "x.class"), "--devices", "2"]) == 1
    assert "--device cuda" in capsys.readouterr().err
