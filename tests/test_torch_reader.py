"""The port's input plane on the CPU: the C++ streaming FASTX reader
(``io.fastx.FastxReader`` over ``cp_fx_next``) and the wall stage that
decodes each read's FASTK profile in the worker that walks it
(``NativeWall.wall_stage_fastk``).

- Records: the reader, the port's plain Python reader
  (``_read_fastx_plain``) and the JAX package's ``read_fastx`` agree
  record for record on tests/test_io.py's ten FASTX texts (written out
  again here), each plain and gzipped, on multi-member gzip, on every
  committed fixture's reads.fasta.gz and on FASTX texts drawn by
  hypothesis, at chunk sizes 1, 2, 3, 7 and 200 and at input blocks small
  enough that records straddle them.  Trailing garbage after a gzip
  member and a file that is neither FASTA nor FASTQ raise in all three.
  Where the JAX package's native whole-blob parse (``cp_fastx_parse``)
  departs from its own Python reader, which it names as its spec, the
  port holds to the spec: an empty line where a FASTQ header is due is
  an empty header (the native parse takes that line's terminator as the
  mark and reads the next line as the header), and the native parse
  stops at newlines // 2 + 2 records.  On every drawn text the port
  equals that Python reader (``_jax_spec``, the native parse switched
  off), and the JAX records equal a model of the native parse
  (``_jax_native_records``).
- The fused decode and wall stage: its slab, n_out and n_rel equal
  ``wall_stage_slab`` over ``fetch_batch``'s profiles, bit for bit, at
  T = 1 and 8, on medium's chunks and on a chunk that straddles a profile
  part (``write_profiles(..., nparts=3)``).
- Refusals: a profile whose length is not the read's (on the main path,
  the shard driver and ``fetch_batch``; of two in one sort window, the
  first in the file), a read over the maximum length and a truncated
  part raise their messages; the CLI exits 1.
- Memory: the reader's capacity on a file of 10x the reads equals that
  on 1x.
- No fallback: with the host library made to fail, the reader, ``fetch``,
  ``fetch_batch`` and ``fastx_chunks`` raise.
Tolerance: equality (records, bytes and bits).
"""
import dataclasses
import gzip
import os
import pathlib
import re
import shutil
import tempfile
from unittest import mock

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

os.environ.setdefault("JAX_PLATFORMS", "cpu")
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIX = ROOT / "tests" / "fixtures"
FIXTURES = sorted(str(p.parent.relative_to(FIX))
                  for p in FIX.rglob("reads.fasta.gz"))
CHUNKS = (1, 2, 3, 7, 200)
BLOCKS = (1, 2, 3, 5, 64, 1 << 20)

CASES = {
    "plain.fa": b">r1 a comment here\nACGT\nTTGG\n>r2\nAC\n>r3 x\n\nGG\n",
    "crlf.fa": b">r1 com\r\nACG\r\nT\r\n>r2\r\nAA\r\n",
    "lonecr.fa": b">r1 c\rACGT\rGG\r>r2\rAA\r",
    "fq.fq": b"@q1 c1\nACGT\n+\nIIII\n@q2\nGG\n+x\nII\n",
    "fq_crlf.fq": b"@q1 c1\r\nACGT\r\n+\r\nIIII\r\n",
    "ws.fa": b">  r1   spaced  comment \n  ACG T \nGG\n",
    "empty.fa": b"",
    "noeol.fa": b">r1\nACGT",
    "fq_noeol.fq": b"@q1\nAC\n+\nII",
    "nameless.fa": b"> only comment\nAC\n",
}


def _chunked(path, B: int, block: int, **kw) -> list:
    """Every record through ``FastxReader.next_chunk(B)``."""
    from classpro_tpu_torch.io.fastx import FastxReader

    out = []
    with FastxReader(str(path), block=block, **kw) as rd:
        while True:
            c = rd.next_chunk(B)
            if c is None:
                return out
            out += c.records()


def _three(path) -> tuple[list, list, list]:
    """(the port's reader, its plain reader, the JAX package's reader) as
    lists of plain tuples."""
    import classpro_tpu.io.fastx as jfx
    from classpro_tpu_torch.io.fastx import _read_fastx_plain, read_fastx

    return ([tuple(r) for r in read_fastx(str(path))],
            [tuple(r) for r in _read_fastx_plain(str(path))],
            [tuple(r) for r in jfx.read_fastx(str(path))])


def _jax_spec(path) -> list:
    """The JAX package's Python reader, which its ``read_fastx`` names as
    the semantic spec, run by switching its native parse off."""
    import classpro_tpu.io.fastx as jfx

    with mock.patch.object(jfx, "_read_fastx_native", lambda p: None):
        return [tuple(r) for r in jfx.read_fastx(str(path))]


def _all_sizes(path, want, blocks=BLOCKS) -> None:
    for B in CHUNKS:
        for block in blocks:
            got = [tuple(r) for r in _chunked(path, B, block)]
            assert got == want, (path, B, block)


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_case_records(name, gz, tmp_path):
    data = CASES[name]
    p = tmp_path / (name + (".gz" if gz else ""))
    p.write_bytes(gzip.compress(data) if gz else data)
    port, plain, jax = _three(p)
    assert port == plain == jax
    _all_sizes(p, plain)


def test_multimember_gzip(tmp_path):
    """Members one after another (an empty one among them) read as one
    text, a record straddling two members included; a stream cut short
    ends the text where the JAX package's whole-blob inflate ends it."""
    p = tmp_path / "mm.fa.gz"
    p.write_bytes(gzip.compress(b">r1 c\nAC\nG") + gzip.compress(b"")
                  + gzip.compress(b"T\n>r2\nGT\n") + gzip.compress(b">r3\n"))
    port, plain, jax = _three(p)
    assert port == plain == jax
    assert [r[2] for r in port] == ["ACGT", "GT", ""]
    _all_sizes(p, plain)
    cut = tmp_path / "cut.fa.gz"
    bases = np.frombuffer(b"ACGT", np.uint8)[
        np.random.default_rng(0).integers(0, 4, 200000)].tobytes()
    whole = gzip.compress(b">r1\n" + bases + b"\n>r2\nAC\n")
    cut.write_bytes(whole[: len(whole) // 2])
    import classpro_tpu.io.fastx as jfx
    want = [tuple(r) for r in jfx.read_fastx(str(cut))]
    assert len(want) == 1 and 0 < len(want[0][2]) < 200000
    _all_sizes(cut, want, blocks=(7, 64, 1 << 20))


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
def test_not_fastx_raises(gz, tmp_path):
    import classpro_tpu.io.fastx as jfx
    from classpro_tpu_torch.io.fastx import _read_fastx_plain, read_fastx

    p = tmp_path / ("bad.txt" + (".gz" if gz else ""))
    p.write_bytes(gzip.compress(b"hello\n") if gz else b"hello\n")
    for reader in (read_fastx, _read_fastx_plain, jfx.read_fastx):
        with pytest.raises(ValueError, match="not FASTA/FASTQ \\(starts "
                                             "with 'h'\\)"):
            list(reader(str(p)))


def test_trailing_garbage_raises(tmp_path):
    import classpro_tpu.io.fastx as jfx
    from classpro_tpu_torch.io.fastx import _read_fastx_plain, read_fastx

    p = tmp_path / "junk.fa.gz"
    p.write_bytes(gzip.compress(b">r1\nACGT\n") + b"garbage!")
    for reader in (read_fastx, jfx.read_fastx):
        with pytest.raises(OSError, match="corrupt gzip stream"):
            list(reader(str(p)))
    with pytest.raises(OSError):
        list(_read_fastx_plain(str(p)))
    for block in (1, 5, 1 << 20):
        with pytest.raises(OSError, match="corrupt gzip stream"):
            _chunked(p, 2, block)


@pytest.mark.parametrize("fx", FIXTURES)
def test_fixture_records(fx):
    p = FIX / fx / "reads.fasta.gz"
    port, plain, jax = _three(p)
    assert port == plain == jax and port
    for B, block in ((7, 4096), (200, 1 << 20), (1, 65536)):
        assert [tuple(r) for r in _chunked(p, B, block)] == plain


_NL = st.sampled_from(["\n", "\r\n", "\r"])
_WS = st.sampled_from([" ", "\t", "  ", " \t ", "\v", "\f"])
_NAME = st.text(alphabet="ACGTacgt_-.:/|019xyz", max_size=8)
_COMMENT = st.text(alphabet="abc XYZ\t=;,", max_size=10)
_BASES = st.text(alphabet="ACGTN", max_size=14)


@st.composite
def _padded(draw, core):
    return draw(st.sampled_from(["", " ", "\t"])) + draw(core) \
        + draw(st.sampled_from(["", " ", "\t "]))


@st.composite
def fastx_texts(draw):
    """A FASTA or FASTQ text: headers with and without comments and
    whitespace runs, sequence lines padded with whitespace, empty lines,
    any newline convention per line, with or without a final newline."""
    fastq = draw(st.booleans())
    out = []
    for _ in range(draw(st.integers(0, 5))):
        hdr = draw(_padded(_NAME))
        comment = draw(_COMMENT)
        if comment:
            hdr += draw(_WS) + comment
        if fastq:
            out.append("@" + hdr + draw(_NL) + draw(_padded(_BASES))
                       + draw(_NL) + "+" + draw(_NAME) + draw(_NL)
                       + draw(_padded(_BASES)) + draw(_NL))
        else:
            out.append(">" + hdr + draw(_NL) + "".join(
                draw(_padded(_BASES)) + draw(_NL)
                for _ in range(draw(st.integers(0, 4)))))
    text = "".join(out)
    if draw(st.booleans()):
        text = text.rstrip("\r\n")
    return text.encode()


_WS_BYTES = b" \t\n\r\v\f"


def _jax_native_records(text: bytes) -> list[tuple]:
    """The records the JAX package's ``read_fastx`` gives for ``text``: a
    model of its native whole-blob parse (``cp_fastx_parse``).  Its line
    model is the Python reader's ('\\n', '\\r\\n' and a lone '\\r' end a
    line), and it departs from that reader in two places: it sizes its
    record table at newlines // 2 + 2 records and stops there (on texts
    of many one-line records or of lone-CR newlines), and it takes the
    byte at a FASTQ header's place as the mark whatever that byte is, so
    an empty line ended by one byte there gives up its terminator and
    the next line is read as the header."""
    n = len(text)
    if not n:
        return []

    def line(i: int) -> tuple[int, int]:
        """The end of the line from ``i`` and where the next one starts."""
        e = i
        while e < n and text[e] not in b"\r\n":
            e += 1
        if e < n and text[e] == 13 and e + 1 < n and text[e + 1] == 10:
            return e, e + 2
        return e, min(e + 1, n)

    def stripped(a: int, b: int) -> str:
        while a < b and text[a] in _WS_BYTES:
            a += 1
        while b > a and text[b - 1] in _WS_BYTES:
            b -= 1
        return text[a:b].decode()

    fastq = text[:1] == b"@"
    out, pos = [], 0
    while pos < n and len(out) < text.count(b"\n") // 2 + 2:
        h0 = pos + 1                  # the byte at pos is the mark
        he, pos = line(h0)
        n0 = h0
        while n0 < he and text[n0] in _WS_BYTES:
            n0 += 1
        n1 = n0
        while n1 < he and text[n1] not in _WS_BYTES:
            n1 += 1
        c0 = n1
        while c0 < he and text[c0] in _WS_BYTES:
            c0 += 1
        name, comment = text[n0:n1].decode(), text[c0:he].decode()
        if fastq:
            a, (b, pos) = pos, line(pos)
            seq = stripped(a, b)
            _, pos = line(pos)        # the '+' line
            a, (b, pos) = pos, line(pos)
            out.append((name, comment, seq, stripped(a, b)))
            continue
        seq = []
        while pos < n and text[pos] != ord(">"):
            a, (b, pos) = pos, line(pos)
            seq.append(stripped(a, b))
        out.append((name, comment, "".join(seq), None))
    return out


# the text on which the JAX records first departed from the plain
# reader's (an empty line at a FASTQ header's place, ended by '\n')
F1_TEXT = b"@\n\n+\n\n@\n\n+\r\n@\n\n+\n\n"


@settings(max_examples=150, deadline=None)
@given(text=fastx_texts(), gz=st.booleans(),
       B=st.sampled_from(CHUNKS), block=st.sampled_from(BLOCKS))
@example(text=F1_TEXT, gz=False, B=1, block=1)
@example(text=F1_TEXT, gz=True, B=200, block=1 << 20)
def test_drawn_texts(text, gz, B, block):
    with tempfile.TemporaryDirectory() as d:
        p = pathlib.Path(d) / ("x.fx" + (".gz" if gz else ""))
        p.write_bytes(gzip.compress(text) if gz else text)
        port, plain, jax = _three(p)
        assert port == plain == _jax_spec(p)
        # the JAX package's native parse, modelled: its record cap and
        # its FASTQ header rule (the port's reader and the spec have
        # neither)
        assert jax == _jax_native_records(text)
        assert [tuple(r) for r in _chunked(p, B, block)] == plain


# an empty line where a FASTQ header is due: the spec reading (the JAX
# package's Python reader, which the port and its plain reader follow)
# is an empty header, whatever ends the line
EMPTY_HEADER = {
    "lf": (b"@r1 c\nAC\n+\nII\n\nGG\n+\nJJ\n",
           [("r1", "c", "AC", "II"), ("", "", "GG", "JJ")]),
    "lone_cr": (b"@r1\rAC\r+\rII\r\rGG\r+\rJJ\r@r3 x\rT\r+\rK\r",
                [("r1", "", "AC", "II"), ("", "", "GG", "JJ"),
                 ("r3", "x", "T", "K")]),
    "crlf": (b"@r1\r\nAC\r\n+\r\nII\r\n\r\nGG\r\n+\r\nJJ\r\n",
             [("r1", "", "AC", "II"), ("", "", "GG", "JJ")]),
    "f1": (F1_TEXT, [("", "", "", ""), ("", "", "", "@"),
                     ("", "", "+", "")]),
}


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gz"])
@pytest.mark.parametrize("name", sorted(EMPTY_HEADER))
def test_empty_fastq_header_line(name, gz, tmp_path):
    text, want = EMPTY_HEADER[name]
    p = tmp_path / ("e.fq" + (".gz" if gz else ""))
    p.write_bytes(gzip.compress(text) if gz else text)
    port, plain, jax = _three(p)
    assert port == plain == _jax_spec(p) == want
    assert jax == _jax_native_records(text)
    _all_sizes(p, want)


# ---------------------------------------------------------------------
# the fused decode and wall stage

def _model(d: pathlib.Path):
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram

    return build_global_model(load_histogram(str(d / "reads")))


def _same_slab(a, b) -> None:
    """Two wall stages' outputs equal bit for bit on every record."""
    slab1, n_out1, n_rel1, slot1 = a[:4]
    slab2, n_out2, n_rel2, slot2 = b[:4]
    assert np.array_equal(n_out1, n_out2)
    assert np.array_equal(n_rel1, n_rel2)
    for i, n in enumerate(n_out1):
        r1 = slab1[i * slot1: i * slot1 + n]
        r2 = slab2[i * slot2: i * slot2 + n]
        for f in ("b", "e", "cb", "ce", "ccb", "cce", "is_rel"):
            assert np.array_equal(r1[f], r2[f]), (i, f)
        for f in ("pe", "pe_o_b", "pe_o_e"):
            assert np.array_equal(r1[f].view(np.uint64),
                                  r2[f].view(np.uint64)), (i, f)


def _fused_vs_decoded(d: pathlib.Path, P, threads: int) -> int:
    """Every chunk of ``d``'s FASTA through both wall stages; the number
    of reads compared."""
    from classpro_tpu_torch.engine import fastx_chunks
    from classpro_tpu_torch.native import NativeWall

    gm = _model(d)
    wall = NativeWall(gm)
    n = 0
    for c in fastx_chunks(str(d / "reads.fasta.gz"), P, gm.kmer, 200):
        g = np.flatnonzero(c.plen[:c.n] > 0)
        g = g[np.argsort(c.plen[g], kind="stable")]
        fused = wall.wall_stage_fastk(
            c.seq_addr()[g], c.seq_len[g], c.prof_addr[g], c.prof_nb[g],
            c.plen[g], threads=threads)
        assert np.array_equal(fused[4], c.plen[g])
        seqs = c.seqs()
        profs = P.fetch_batch(c.rid0 + g, c.plen[g])
        plain = wall.wall_stage_slab([seqs[i].encode() for i in g], profs,
                                     threads=threads)
        _same_slab(fused, plain)
        n += len(g)
        wall.release_slab(fused[0])
        wall.release_slab(plain[0])
    return n


@pytest.mark.parametrize("threads", [1, 8])
def test_fused_wall_stage_on_medium(threads):
    from classpro_tpu_torch.io.fastk import open_profiles

    d = FIX / "medium"
    assert _fused_vs_decoded(d, open_profiles(str(d / "reads")),
                             threads) == 398


def _three_parts(dst: pathlib.Path) -> pathlib.Path:
    """tiny with its profiles re-written as three parts (74, 74 and 73
    reads: every chunk of 200 straddles a part boundary)."""
    from classpro_tpu_torch.io.fastk import open_profiles, write_profiles

    P = open_profiles(str(FIX / "tiny" / "reads"))
    write_profiles(str(dst / "reads"), [P.fetch(i) for i in range(P.nreads)],
                   P.kmer, nparts=3)
    for f in ("reads.hist", "reads.fasta.gz", "golden.class.gz"):
        shutil.copy(FIX / "tiny" / f, dst / f)
    return dst


@pytest.mark.parametrize("threads", [1, 8])
def test_fused_wall_stage_across_parts(threads, tmp_path):
    from classpro_tpu_torch.io.fastk import open_profiles

    d = _three_parts(tmp_path)
    P = open_profiles(str(d / "reads"))
    assert P.nparts == 3 and P.nbase == [74, 148, 221]
    assert _fused_vs_decoded(d, P, threads) > 150


@pytest.mark.parametrize("alldev", [False, True], ids=["main", "alldev"])
def test_three_parts_write_the_golden(alldev, tmp_path):
    """The engine's stream over reader chunks whose reads straddle the
    profile parts writes tiny's golden on both paths."""
    from classpro_tpu_torch.engine import (TorchEngine, chunk_records,
                                           fastx_chunks)
    from classpro_tpu_torch.io.fastk import open_profiles

    d = _three_parts(tmp_path)
    gm = _model(d)
    P = open_profiles(str(d / "reads"))
    eng = TorchEngine(gm, device="cpu", alldev=alldev)
    chunks = list(fastx_chunks(str(d / "reads.fasta.gz"), P, gm.kmer, 200))
    text = "".join(f"{r.header}\n{r.seq}\n+\n{r.classes}\n"
                   for c, cls in zip(chunks, eng.classify_stream(
                       iter(chunks), sort_window=8))
                   for r in chunk_records(c, cls))
    assert text == gzip.decompress(
        (d / "golden.class.gz").read_bytes()).decode()


# ---------------------------------------------------------------------
# refusals

def _mismatched(dst: pathlib.Path, read0: str) -> tuple[pathlib.Path, str]:
    """tiny with read 0's sequence replaced by ``read0``: its FASTA and
    the message the reference's refusal gives."""
    from classpro_tpu_torch.io.fastk import open_profiles
    from classpro_tpu_torch.io.fastx import read_fastx

    for f in ("reads.hist", "reads.prof", ".reads.pidx.1", ".reads.prof.1"):
        shutil.copy(FIX / "tiny" / f, dst / f)
    recs = list(read_fastx(str(FIX / "tiny" / "reads.fasta.gz")))
    fa = dst / "reads.fasta"
    with open(fa, "w") as f:
        for i, r in enumerate(recs):
            f.write(f">{r.name} {r.comment}\n{read0 if i == 0 else r.seq}\n")
    P = open_profiles(str(dst / "reads"))
    plen = len(P.fetch(0))
    return fa, (f"Read 0: rlen ({len(read0)}) != plen+Km1 "
                f"({plen + P.kmer - 1}) — profile/read mismatch")


@pytest.mark.parametrize("how", ["longer", "shorter_than_k"])
def test_profile_mismatch_raises(how, tmp_path, capsys):
    from classpro_tpu_torch.cli import main
    from classpro_tpu_torch.engine import classify_file_torch
    from classpro_tpu_torch.io.fastk import open_profiles
    from classpro_tpu_torch.io.fastx import read_fastx
    from classpro_tpu_torch.parallel.driver import run_process

    seq0 = next(iter(read_fastx(str(FIX / "tiny" / "reads.fasta.gz")))).seq
    fa, msg = _mismatched(tmp_path, seq0 + "ACGTACGTAC" if how == "longer"
                          else "ACGTA")
    root = str(tmp_path / "reads")
    with pytest.raises(ValueError, match=re.escape(msg)):
        list(classify_file_torch(str(fa), root, device="cpu"))
    with pytest.raises(ValueError, match=re.escape(msg)):
        run_process(str(fa), root, str(tmp_path / "o.class"), 1, 0, None,
                    device="cpu")
    P = open_profiles(root)
    rlen = len(seq0) + 10 if how == "longer" else 5
    with pytest.raises(ValueError, match="Read 0: rlen .* profile/read "
                                         "mismatch"):
        P.fetch_batch([0, 1], [max(rlen - P.kmer + 1, 0), len(P.fetch(1))])
    rc = main(["classify", str(fa), "-N", root, "-o",
               str(tmp_path / "c.class"), "--device", "cpu"])
    assert rc == 1
    assert "profile/read mismatch" in capsys.readouterr().err


def test_first_mismatch_in_file_order_is_named(tmp_path):
    """Two mismatched reads of one sort window whose profile-length order
    is not their file order, staged in different device batches: the
    refusal names the first in the file (ClassPro.c:184-187), on both
    paths and in the shard driver."""
    from classpro_tpu_torch.engine import (TorchEngine, classify_file_torch,
                                           fastx_chunks)
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram, open_profiles
    from classpro_tpu_torch.io.fastx import read_fastx
    from classpro_tpu_torch.parallel.driver import run_process

    for f in ("reads.hist", "reads.prof", ".reads.pidx.1", ".reads.prof.1"):
        shutil.copy(FIX / "tiny" / f, tmp_path / f)
    root = str(tmp_path / "reads")
    P = open_profiles(root)
    K = P.kmer
    seqs = [r.seq for r in read_fastx(str(FIX / "tiny" / "reads.fasta.gz"))]
    seqs[1] += "ACGTACGTAC"             # plen 10 over its profile's
    seqs[5] = seqs[5][: K + 5]          # plen 6: staged first
    fa = tmp_path / "reads.fasta"
    fa.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(seqs)))
    B, W = 2, 8                         # classify's sort window
    order = np.argsort([max(len(s) - K + 1, 0) for s in seqs[:B * W]],
                       kind="stable").tolist()
    assert order.index(5) // B < order.index(1) // B
    msg = (f"Read 1: rlen ({len(seqs[1])}) != plen+Km1 "
           f"({len(P.fetch(1)) + K - 1}) — profile/read mismatch")
    with pytest.raises(ValueError, match=re.escape(msg)):
        list(classify_file_torch(str(fa), root, batch_size=B, device="cpu"))
    gm = build_global_model(load_histogram(root))
    eng = TorchEngine(gm, batch_size=B, device="cpu", alldev=True)
    with pytest.raises(ValueError, match=re.escape(msg)):
        list(eng.classify_stream(fastx_chunks(str(fa), P, K, B),
                                 sort_window=W))
    with pytest.raises(ValueError, match=re.escape(msg)):
        run_process(str(fa), root, str(tmp_path / "o.class"), 1, 0, None,
                    batch_size=B, device="cpu")


def test_read_over_max_len_raises(monkeypatch):
    from classpro_tpu_torch.engine import fastx_chunks
    from classpro_tpu_torch.io.fastk import open_profiles
    from classpro_tpu_torch.io.fastx import (_read_fastx_plain,
                                             read_fastx_checked)

    src = str(FIX / "tiny" / "reads.fasta.gz")
    plain = list(_read_fastx_plain(src))
    cap = sorted(len(r.seq) for r in plain)[len(plain) // 2]
    first = next(i for i, r in enumerate(plain) if len(r.seq) > cap)
    msg = (f"rlen ({len(plain[first].seq)}) > MAX_READ_LEN for FASTX "
           f"inputs ({cap})")
    got = []
    with pytest.raises(ValueError, match=re.escape(msg)):
        for r in read_fastx_checked(src, cap):
            got.append(r)
    assert got == plain[:first]
    for B, block in ((1, 64), (3, 4096), (200, 1 << 20)):
        with pytest.raises(ValueError, match=re.escape(msg)):
            _chunked(src, B, block, max_len=cap)
    import classpro_tpu_torch.engine as E

    P = open_profiles(str(FIX / "tiny" / "reads"))
    monkeypatch.setattr(E, "DEFAULTS", dataclasses.replace(
        E.DEFAULTS, max_read_len=cap))
    with pytest.raises(ValueError, match=re.escape(msg)):
        list(fastx_chunks(src, P, P.kmer, 200))


def test_truncated_part_raises(tmp_path):
    from classpro_tpu_torch.engine import classify_file_torch, fastx_chunks
    from classpro_tpu_torch.io.fastk import open_profiles

    for f in ("reads.hist", "reads.prof", ".reads.pidx.1", ".reads.prof.1",
              "reads.fasta.gz"):
        shutil.copy(FIX / "tiny" / f, tmp_path / f)
    p = tmp_path / ".reads.prof.1"
    p.write_bytes(p.read_bytes()[: p.stat().st_size // 2])
    root = str(tmp_path / "reads")
    fa = str(tmp_path / "reads.fasta.gz")
    for run in (lambda: open_profiles(root).fetch(0),
                lambda: list(fastx_chunks(fa, open_profiles(root), 40, 200)),
                lambda: list(classify_file_torch(fa, root, device="cpu"))):
        with pytest.raises(ValueError, match="truncated profile part"):
            run()


# ---------------------------------------------------------------------
# memory and the host library

def test_capacity_does_not_grow_with_the_file(tmp_path):
    from classpro_tpu_torch.io.fastx import FastxReader, read_fastx

    recs = list(read_fastx(str(FIX / "tiny" / "reads.fasta.gz")))
    caps = {}
    for times in (1, 10):
        for gz in (False, True):
            text = "".join(f">{r.name}_{k} {r.comment}\n{r.seq}\n"
                           for k in range(times) for r in recs).encode()
            p = tmp_path / f"x{times}.fa{'.gz' if gz else ''}"
            p.write_bytes(gzip.compress(text) if gz else text)
            with FastxReader(str(p), block=1 << 16) as rd:
                n = 0
                while (c := rd.next_chunk(200)) is not None:
                    n += c.n
                assert n == times * len(recs)
                caps[times, gz] = rd.stats()["capacity"]
    assert caps[1, False] == caps[10, False]
    assert caps[1, True] == caps[10, True]
    longest = max(len(r.seq) for r in recs)
    assert caps[10, True] <= 4 * ((1 << 16) + longest + 1024)


def test_no_fallback_without_the_host_library(monkeypatch):
    import classpro_tpu_torch.native as native
    from classpro_tpu_torch.engine import fastx_chunks
    from classpro_tpu_torch.io.fastk import open_profiles
    from classpro_tpu_torch.io.fastx import read_fastx

    P = open_profiles(str(FIX / "tiny" / "reads"))
    src = str(FIX / "tiny" / "reads.fasta.gz")

    def broken(force=False):
        raise RuntimeError("host library unavailable")
    monkeypatch.setattr(native, "get_lib", broken)
    for run in (lambda: list(read_fastx(src)), lambda: P.fetch(0),
                lambda: P.fetch_batch([0, 1], [100, 100]),
                lambda: list(fastx_chunks(src, P, P.kmer, 200))):
        with pytest.raises(RuntimeError, match="host library unavailable"):
            run()


def test_whole_blob_entries_are_gone_and_the_fused_one_pooled():
    from classpro_tpu_torch.native import _SRC, get_lib

    code = pathlib.Path(_SRC).read_text()
    lib = get_lib()
    for name in ("cp_gzip_inflate", "cp_fastx_parse"):
        assert not re.search(rf"\b{name}\s*\(", code), name
        assert not hasattr(lib, name), name
    assert "libdeflate" not in code
    body = code[code.index(" cp_wall_stage_fastk("):]
    body = body[: body.index("\n}\n")]
    assert "pool::parallel_rows(" in body
    body = code[code.index(" cp_fx_next("):]
    assert "std::thread" not in body[: body.index("\n}\n")]
