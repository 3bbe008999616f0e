"""The port's ``debug-read`` against the JAX package's.

On read 0 of ``branch/psum0`` (the all-dead traceback) the port's dump
on the CPU must print every section, show the all-dead DP cells, end in
``RESULT: oracle == production`` with exit 0, print the JAX tool's
oracle sections text-equal (both run the same oracle), and name the same
production class string.  A production result made to diverge must give
exit 2 and the first divergent base; ``first_divergent_read`` agrees with
the JAX copy.  On a card, the dump on ``cuda`` agrees too (``gpu``).
"""
import contextlib
import io
import json
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "fixtures"
PSUM0 = FIX / "branch" / "psum0"
TINY = FIX / "tiny"
SECTIONS = ("oracle wall stage", "oracle rel DP", "oracle final",
            "production wall stage (C++)", "device DP", "production final",
            "RESULT: oracle == production")
ALL_DEAD = "dp[  1] E:        -inf  R:        -inf  H:        -inf"


def _psum0_args():
    a = json.loads((PSUM0 / "args.json").read_text())
    return [str(PSUM0 / "reads.fasta.gz"), "0", "-c", str(a["coverage"]),
            "-r", str(a["read_len"])]


def _run(main, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def psum0_dumps():
    """(rc, text) of the port's debug-read on the CPU and of the JAX
    CLI's, on psum0 read 0."""
    from classpro_tpu.cli import main as jax_main
    from classpro_tpu_torch.cli import main as port_main

    port = _run(port_main, ["debug-read", *_psum0_args(), "--device", "cpu"])
    jax = _run(jax_main, ["debug-read", *_psum0_args()])
    return port, jax


def _final_classes(text: str) -> str:
    tail = text.split("--- production final ---")[1]
    return tail.split("classes:")[1].split("\n")[0].strip()


def test_port_debug_read_psum0_prints_every_section(psum0_dumps):
    (rc, out), _ = psum0_dumps
    assert rc == 0
    for s in SECTIONS:
        assert s in out, s
    assert ALL_DEAD in out
    assert "device DP (cpu" in out


def test_oracle_sections_equal_jax(psum0_dumps):
    """Everything before the production half (header, model, oracle wall
    stage, raw fw/bw DP, oracle final) is the same text."""
    (_, out), (jrc, jout) = psum0_dumps
    assert jrc == 0
    cut = "--- production wall stage (C++) ---"
    assert out.split(cut)[0] == jout.split(cut)[0]


def test_production_final_equals_jax(psum0_dumps):
    (_, out), (_, jout) = psum0_dumps
    assert _final_classes(out) == _final_classes(jout)
    assert "RESULT: oracle == production" in jout
    # the production wall records are the C++ records the JAX tool prints
    cut = "--- production wall stage (C++) ---"
    rows = out.split(cut)[1].split("--- device DP")[0]
    jrows = jout.split(cut)[1].split("--- device DP")[0]
    assert rows == jrows


def test_divergent_production_exits_2(monkeypatch, capsys):
    """A production string with one base changed: exit 2, the first
    divergent base and the oracle interval it falls in."""
    from classpro_tpu_torch.cli import main
    from classpro_tpu_torch.tools import debug_read as dr

    orig = dr._production
    hit = {}

    def flipped(eng, seq, profile, intvls, out):
        cls = orig(eng, seq, profile, intvls, out)
        pos = eng.gm.kmer - 1 + 100
        hit["pos"] = pos
        return cls[:pos] + ("E" if cls[pos] != "E" else "R") + cls[pos + 1:]

    monkeypatch.setattr(dr, "_production", flipped)
    rc = main(["debug-read", str(TINY / "reads.fasta.gz"), "0", "--device",
               "cpu"])
    out = capsys.readouterr().out
    assert rc == 2
    assert f"*** DIVERGENT *** first diff at base {hit['pos']}:" in out
    assert "divergent base falls in oracle interval" in out


def test_first_divergent_read_matches_jax(tmp_path):
    from classpro_tpu.tools.debug_read import first_divergent_read as jfdr
    from classpro_tpu_torch.tools.debug_read import first_divergent_read

    recs = [f"@r{i}\nACGT\n+\nNNEH\n" for i in range(5)]
    a = tmp_path / "a.class"
    a.write_text("".join(recs))
    cases = {"same": recs, "read3": recs[:3] + ["@r3\nACGT\n+\nNNED\n"]
             + recs[4:], "short": recs[:2], "hdr0": ["@x\nACGT\n+\nNNEH\n"]
             + recs[1:]}
    for name, rs in cases.items():
        b = tmp_path / f"{name}.class"
        b.write_text("".join(rs))
        assert first_divergent_read(str(a), str(b)) == \
            jfdr(str(a), str(b)), name
    assert first_divergent_read(str(a), str(tmp_path / "same.class")) == -1
    assert first_divergent_read(str(a), str(tmp_path / "read3.class")) == 3


def test_debug_read_cuda_without_card_raises():
    """--device cuda never falls back to the CPU."""
    from classpro_tpu_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["debug-read", str(TINY / "reads.fasta.gz"), "0"])


@pytest.mark.gpu
def test_debug_read_on_card(capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from classpro_tpu_torch.cli import main

    rc = main(["debug-read", *_psum0_args(), "--device", "cuda"])
    out = capsys.readouterr().out
    assert rc == 0
    for s in SECTIONS:
        assert s in out, s
    assert "device DP (cuda" in out
