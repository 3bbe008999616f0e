"""The port's dataset generators and fuzz driver (classpro_tpu_torch.devtools).

``fuzzgen.build`` and ``write_random_model`` must write the files the
repo-root ``tools/parity_fuzz.py`` writes for the same seed and options,
byte for byte (a gzip container is compared on its content: its header
carries the write time), and the ``sc_*`` scenarios must equal
``tools/branch_probe.py``'s; ``soak.generate`` must write
``tools/soak.py``'s dataset.  The fuzz driver on the CPU reports
IDENTICAL against the port's exact oracle in the default, ``--dam`` and
``--model`` modes.  On a card, one fuzz dataset through both device paths
agrees with the oracle (``gpu``).
"""
import gzip
import os
import pathlib

import numpy as np
import pytest
import torch

import tools.branch_probe as bp
import tools.parity_fuzz as pf
from classpro_tpu_torch.devtools import fuzzgen

ROOT = pathlib.Path(__file__).resolve().parent.parent
NO_REF = "/nonexistent/ClassPro"     # the exact oracle decides


def _content(p: pathlib.Path) -> bytes:
    data = p.read_bytes()
    return gzip.decompress(data) if p.name.endswith(".gz") else data


def _same_tree(a: pathlib.Path, b: pathlib.Path) -> None:
    fa = sorted(x.name for x in a.iterdir())
    assert fa == sorted(x.name for x in b.iterdir())
    for name in fa:
        assert _content(a / name) == _content(b / name), name


# seeds 1000 / 1005 / 1009 / 1002 draw reads.fasta / .fasta.gz /
# .fastq.gz / .fastq; K 16 / 32 / 40 / 32
@pytest.mark.parametrize("mode,seed", [
    ("plain", 1000), ("plain", 1005), ("plain", 1009), ("plain", 1002),
    ("dam", 1000), ("dam", 1001), ("extreme", 1003), ("extreme", 1004),
    ("cap", 1006), ("cap", 1007), ("ndense", 1008), ("ndense", 1013)])
def test_build_matches_jax_tool(mode, seed, tmp_path, monkeypatch):
    monkeypatch.setattr(pf, "_GEN", {"extreme": bp._extreme_batch,
                                     "cap": bp._cap_batch}.get(mode))
    monkeypatch.setattr(pf, "_NDENSE", mode == "ndense")
    monkeypatch.setattr(bp, "K", bp.K)
    j = pf.build(seed, str(tmp_path / "j"), dam=mode == "dam")
    p = fuzzgen.build(seed, str(tmp_path / "p"), dam=mode == "dam",
                      gen=fuzzgen.GENERATORS.get(mode),
                      ndense=mode == "ndense")
    assert j == p
    _same_tree(tmp_path / "j", tmp_path / "p")


@pytest.mark.parametrize("seed", [1000, 1003, 5, 77])
def test_write_random_model_matches_jax_tool(seed, tmp_path):
    def run(fn, path):
        try:
            return fn(seed, str(path))
        except RuntimeError as e:
            return str(e)

    kj = run(pf.write_random_model, tmp_path / "j.model")
    kp = run(fuzzgen.write_random_model, tmp_path / "p.model")
    assert kj == kp
    if isinstance(kj, int):
        assert (tmp_path / "j.model").read_bytes() == \
            (tmp_path / "p.model").read_bytes()


SCENARIOS = ["sc_uniform_grid", "sc_drift", "sc_high", "sc_errors",
             "sc_overflow", "sc_tall_h", "sc_longrun", "sc_dips",
             "sc_smallk", "sc_stepdip", "sc_psum0", "sc_psum0multi"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_scenarios_match_branch_probe(name, monkeypatch):
    monkeypatch.setattr(bp, "K", 40)
    j = getattr(bp, name)(np.random.default_rng(3))
    p = getattr(fuzzgen, name)(np.random.default_rng(3))
    assert len(j) == len(p)
    np.testing.assert_array_equal(j[0], p[0])
    assert len(j[1]) == len(p[1])
    for (cj, rj), (cp, rp) in zip(j[1], p[1]):
        np.testing.assert_array_equal(cj, cp)
        assert rj == rp
    assert j[2:] == p[2:]


@pytest.mark.parametrize("K", [16, 24])
def test_batches_take_k_as_argument(K, monkeypatch):
    """The module constant the JAX generators read is an argument here."""
    monkeypatch.setattr(bp, "K", K)
    for jf, pfn in ((bp._random_batch, fuzzgen._random_batch),
                    (bp._extreme_batch, fuzzgen._extreme_batch),
                    (bp._cap_batch, fuzzgen._cap_batch)):
        hj, rj = jf(11)
        hp, rp = pfn(11, K)
        np.testing.assert_array_equal(hj, hp)
        for (cj, _), (cp, _) in zip(rj, rp):
            np.testing.assert_array_equal(cj, cp)


def test_soak_generate_matches_jax_tool(tmp_path, monkeypatch):
    import tools.soak as jsoak
    from classpro_tpu_torch.devtools import soak

    monkeypatch.setattr(jsoak, "K", jsoak.K)
    mj = jsoak.generate(str(tmp_path / "j"), 0.0008)
    mp = soak.generate(str(tmp_path / "p"), 0.0008)
    for m in (mj, mp):
        m.pop("gen_seconds")
    assert mj == mp and mp["kmer"] == 28
    os.remove(tmp_path / "j" / "meta.json")
    os.remove(tmp_path / "p" / "meta.json")
    _same_tree(tmp_path / "j", tmp_path / "p")


def test_kmer_codes_match_jax_tool(monkeypatch):
    import tools.soak as jsoak
    from classpro_tpu_torch.devtools import soak

    rng = np.random.default_rng(4)
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 500)].copy()
    for K in (16, 28, 32):
        monkeypatch.setattr(jsoak, "K", K)
        np.testing.assert_array_equal(jsoak._kmer_codes(seq),
                                      soak._kmer_codes(seq, K))


def _fuzz(args, capsys, tmp_path):
    from classpro_tpu_torch.devtools import parity_fuzz

    rc = parity_fuzz.main([*args, "--device", "cpu", "--ref", NO_REF,
                           "--workdir", str(tmp_path)])
    return rc, capsys.readouterr().out


def test_fuzz_driver_identical_on_cpu(capsys, tmp_path):
    rc, out = _fuzz(["2", "1000"], capsys, tmp_path)
    assert rc == 0, out
    assert out.count("IDENTICAL") == 2
    assert out.count("[exact oracle]") == 3
    assert "0 divergent/crashed of 2" in out


def test_fuzz_driver_dam_identical_on_cpu(capsys, tmp_path):
    rc, out = _fuzz(["1", "1000", "--dam"], capsys, tmp_path)
    assert rc == 0, out
    assert "IDENTICAL (class + 4 tracks)" in out and "[exact oracle]" in out


def test_fuzz_driver_model_identical_on_cpu(capsys, tmp_path):
    rc, out = _fuzz(["1", "1000", "--model"], capsys, tmp_path)
    assert rc == 0, out
    assert "(K=16,mK=32) [exact oracle]: IDENTICAL" in out


def test_fuzz_driver_reports_a_divergence(capsys, tmp_path, monkeypatch):
    """A seed whose output differs is reported, kept and triaged."""
    from classpro_tpu_torch.devtools import parity_fuzz

    orig = parity_fuzz.port_cli

    def spoiled(args, timeout=600):
        r = orig(args, timeout)
        if args[0] == "classify" and "--engine" not in args:
            out = args[args.index("-o") + 1]
            lines = open(out).read().split("\n")
            lines[3] = lines[3][:-1] + ("E" if lines[3][-1] != "E" else "R")
            open(out, "w").write("\n".join(lines))
        return r

    monkeypatch.setattr(parity_fuzz, "port_cli", spoiled)
    rc, out = _fuzz(["1", "1001"], capsys, tmp_path)
    assert rc == 1
    assert "*** DIFFERS ***" in out
    assert "first divergent read = 0" in out
    assert (tmp_path / "fuzz_1001" / "ours.class").exists()


@pytest.mark.gpu
def test_fuzz_seed_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from classpro_tpu_torch.devtools import gpu_parity

    _, fname = fuzzgen.build(990001, str(tmp_path))
    rec, = gpu_parity.check_datasets([(str(tmp_path), fname, None)],
                                     "cuda", ref=NO_REF)
    assert rec["oracle"] == "exact oracle"
    for p in ("main", "alldev"):
        assert rec["paths"][p]["mismatches"] == 0, rec


def test_exact_engine_on_dam_writes_the_fixture(tmp_path):
    """``classify -s --engine exact`` on a .dam (the fuzz driver's
    oracle for ``--dam``): the tiny golden and the committed tracks."""
    import shutil

    from classpro_tpu_torch.cli import main

    tiny = ROOT / "tests" / "fixtures" / "tiny"
    d = tmp_path / "dam"
    d.mkdir()
    for fn in ("reads.dam", ".reads.idx", ".reads.bps", ".reads.hdr"):
        shutil.copy(tiny / "dam" / fn, d / fn)
    assert main(["classify", "-s", "--engine", "exact", str(d / "reads.dam"),
                 "-N", str(tiny / "reads")]) == 0
    assert (d / "reads.class").read_bytes() == \
        gzip.decompress((tiny / "golden.class.gz").read_bytes())
    for fn in pf._DAM_OUTS[1:]:
        assert (d / fn).read_bytes() == (tiny / "dam" / fn).read_bytes(), fn
