"""The port's output plane on the CPU: ``io.classfile.ClassWriter``, which
composes each reader chunk's .class records in one C++ call
(``cp_class_compose``) from the reader's name, comment and sequence
bytes and the class lines the host plane left in its buffers
(``io.classfile.ChunkClasses``), and writes them with write(2) on a
thread of its own; and its callers (``cli classify``, a serve job, the shard
driver's ``run_process``).

- Bytes: the writer's file equals ``write_class(chunk_records(...))``
  over the same chunks and classes, and each golden.class.gz, on tiny,
  medium and every branch/* fixture, on the main and all-device paths,
  at -T 1 and 8; through ``cli classify``, a serve job and two shards
  merged; on FASTX texts drawn by hypothesis (FASTA and FASTQ, empty and
  whitespace comments, reads shorter than K, several class buffers).
- The guard: a chunk with a flagged read (branch/psum0*) is written with
  the exact path's lines (on the all-device path, from the exact
  re-decision's own buffer).
- Counts: the writer's read and k-mer counts (``-v``, ``--stats-json``,
  the serve reply) equal the record route's: reads, and class bytes
  other than 'N'.
- The FASTX paths make no per-read object: with ``ClassRecord``,
  ``chunk_records``, the reader chunk's per-read strings, the class
  lines' ``strs`` and ``write_class`` made to raise, classify, a serve
  job and a shard run still write the golden.
- Errors: a failed write (ENOSPC, EIO) or a chunk whose class lines do
  not fit it raises on the caller's thread, and classify exits 1; a host
  library that fails raises (no fallback).
- Lifetime: every class buffer is poisoned when its last reference goes;
  with the writer held back until the stream is over, the file is still
  the golden (the writer's queue alone keeps each chunk's buffers), and
  every buffer is released once written; a writer that keeps addresses
  but drops the buffers writes poison (the check has teeth).
Tolerance: byte equality; counts exact.
"""
import errno
import gc
import gzip
import json
import os
import pathlib
import random
import tempfile
import weakref

import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from test_torch_reader import F1_TEXT, fastx_texts

os.environ.setdefault("JAX_PLATFORMS", "cpu")
torch.set_num_threads(1)

FIX = pathlib.Path(__file__).resolve().parent / "fixtures"
GOLDENS = sorted(str(p.parent.relative_to(FIX))
                 for p in FIX.rglob("golden.class.gz")
                 if (p.parent / "reads.fasta.gz").exists())


def _args(d: pathlib.Path) -> dict:
    f = d / "args.json"
    return json.loads(f.read_text()) if f.exists() else {}


def _golden(fx: str) -> bytes:
    return gzip.decompress((FIX / fx / "golden.class.gz").read_bytes())


def _counts(text: bytes) -> tuple[int, int]:
    """(reads, k-mers) of a .class text as the record route counts them:
    records, and class bytes other than 'N'."""
    lines = text.split(b"\n")
    cls = lines[3::4]
    return len(cls), sum(len(c) - c.count(b"N") for c in cls)


def _engine(fx: str, alldev: bool = False, threads: int = 0,
            batch: int = 200):
    from classpro_tpu_torch.engine import TorchEngine, fastx_chunks
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram, open_profiles

    d = FIX / fx
    gm = build_global_model(load_histogram(str(d / "reads")), **_args(d))
    P = open_profiles(str(d / "reads"))
    eng = TorchEngine(gm, batch_size=batch, threads=threads, device="cpu",
                      alldev=alldev)
    return eng, lambda: fastx_chunks(str(d / "reads.fasta.gz"), P, gm.kmer,
                                     batch)


def _text(recs) -> bytes:
    return "".join(f"{r.header}\n{r.seq}\n+\n{r.classes}\n"
                   for r in recs).encode()


# ---------------------------------------------------------------------
# bytes, on every golden


@pytest.mark.parametrize("threads", [1, 8], ids=["T1", "T8"])
@pytest.mark.parametrize("alldev", [False, True], ids=["main", "alldev"])
@pytest.mark.parametrize("fx", GOLDENS)
def test_writer_equals_records_and_golden(fx, alldev, threads, tmp_path):
    """One stream's ChunkClasses, each chunk both put to the writer and
    made records (``chunk_records`` of its ``strs``): the writer's file,
    ``write_class``'s text and the golden are the same bytes, and the
    writer's counts are the record route's."""
    from classpro_tpu_torch.engine import chunk_classes, chunk_records
    from classpro_tpu_torch.io.classfile import ClassWriter

    eng, chunks = _engine(fx, alldev, threads)
    recs = []
    out = tmp_path / "o.class"
    with ClassWriter(str(out)) as w:
        for c, cc in chunk_classes(eng, chunks(), buffers=True):
            w.put(c, cc)
            recs += chunk_records(c, cc.strs())
    want = _golden(fx)
    assert out.read_bytes() == _text(recs) == want
    assert (w.reads, w.kmers) == _counts(want)
    assert w.seconds["compose"] > 0 and w.seconds["write"] > 0


@pytest.mark.parametrize("alldev,W,B", [(False, 0, 20), (False, 3, 20),
                                        (False, 8, 20), (True, 2, 50)],
                         ids=["main-0", "main-3", "main-8", "alldev-2"])
def test_buffers_stream_is_the_str_stream(alldev, W, B):
    """``classify_stream(buffers=True)`` gives each chunk's lines as the
    str stream gives them, with and without the sort window's numpy
    unsort, over reader chunks and over (seqs, profiles) chunks (the
    all-device path at a larger batch: its plain device stage on the CPU
    costs seconds a chunk)."""
    from classpro_tpu_torch.io.classfile import ChunkClasses

    eng, chunks = _engine("branch/search9", alldev, batch=B)
    rc = list(chunks())
    pairs = [(c.seqs(), c.profiles.fetch_batch(
        np.arange(c.rid0, c.rid0 + c.n), c.plen[:c.n])) for c in rc]
    for src in (rc, pairs):
        want = list(eng.classify_stream(iter(src), sort_window=W))
        got = list(eng.classify_stream(iter(src), sort_window=W,
                                       buffers=True))
        assert all(isinstance(g, ChunkClasses) for g in got)
        assert [g.strs() for g in got] == want
        assert [len(g) for g in got] == [len(x) for x in want]


# ---------------------------------------------------------------------
# the guard's lines


@pytest.mark.parametrize("alldev", [False, True], ids=["main", "alldev"])
@pytest.mark.parametrize("fx", ["branch/psum0", "branch/psum0multi"])
def test_guard_flagged_reads_written_from_the_exact_path(fx, alldev,
                                                         tmp_path,
                                                         monkeypatch):
    """A chunk whose read the guard flags is written with the exact
    path's lines: on the all-device path the flagged read's line points
    into the buffer ``_exact_alldev`` returned; on the main path the
    re-decided rel row went into the chunk's one finish buffer."""
    from classpro_tpu_torch.engine import TorchEngine, write_chunks

    eng, chunks = _engine(fx, alldev)
    exact = []
    orig = TorchEngine._exact_alldev

    def spy(self, st, rs):
        buf, off = orig(self, st, rs)
        exact.append(buf)
        return buf, off
    monkeypatch.setattr(TorchEngine, "_exact_alldev", spy)
    put = []
    from classpro_tpu_torch.io import classfile
    orig_put = classfile.ClassWriter.put
    monkeypatch.setattr(classfile.ClassWriter, "put",
                        lambda w, c, cc: (put.append(cc),
                                          orig_put(w, c, cc))[1])
    out = tmp_path / "o.class"
    write_chunks(str(out), eng, chunks())
    assert out.read_bytes() == _golden(fx)
    assert eng.guard_flagged >= 1
    if alldev:
        assert len(exact) == 1
        used = [cc.bufs[k] for cc in put for k in cc.buf.tolist() if k >= 0]
        assert sum(b is exact[0] for b in used) == eng.guard_flagged
    else:
        assert not exact


# ---------------------------------------------------------------------
# the callers: no per-read object on the FASTX paths


def _no_records(monkeypatch) -> None:
    """Make every per-read object of the record route raise."""
    from classpro_tpu_torch import engine
    from classpro_tpu_torch.io import classfile, fastx

    def boom(*a, **kw):
        raise AssertionError("a per-read object on the output plane")
    monkeypatch.setattr(engine, "ClassRecord", boom)
    monkeypatch.setattr(engine, "chunk_records", boom)
    monkeypatch.setattr(classfile.ChunkClasses, "strs", boom)
    monkeypatch.setattr(classfile, "write_class", boom)
    monkeypatch.setattr(classfile, "ClassRecord", boom)
    for name in ("seqs", "names", "records"):
        monkeypatch.setattr(fastx.ReadChunk, name, boom)


def _cli_args(fx: str) -> list[str]:
    a = _args(FIX / fx)
    return ["-c", str(a.get("coverage", 0)),
            "-r", str(a.get("read_len", 20000))]


@pytest.mark.parametrize("threads", ["1", "8"], ids=["T1", "T8"])
@pytest.mark.parametrize("fx", ["tiny", "branch/psum0multi",
                                "branch/search9"])
def test_cli_classify_writes_the_golden(fx, threads, tmp_path, monkeypatch,
                                        capsys):
    from classpro_tpu_torch import cli

    _no_records(monkeypatch)
    out, sj = tmp_path / "o.class", tmp_path / "st.json"
    rc = cli.main(["classify", str(FIX / fx / "reads.fasta.gz"), "-o",
                   str(out), "--device", "cpu", "-T", threads, "-v",
                   "--stats-json", str(sj)] + _cli_args(fx))
    assert rc == 0
    want = _golden(fx)
    assert out.read_bytes() == want
    stats = json.loads(sj.read_text())
    reads, kmers = _counts(want)
    assert (stats["reads"], stats["kmers"]) == (reads, kmers)
    assert f"{reads} reads, {kmers} k-mers in" in capsys.readouterr().err


def test_serve_job_writes_the_golden(tmp_path, monkeypatch):
    from classpro_tpu_torch import serve

    _no_records(monkeypatch)
    d = FIX / "tiny"
    out = tmp_path / "o.class"
    rep = serve._do_classify({"source": str(d / "reads.fasta.gz"),
                              "output": str(out)}, torch.device("cpu"))
    want = _golden("tiny")
    assert rep["ok"] and out.read_bytes() == want
    assert (rep["reads"], rep["kmers"]) == _counts(want)
    assert rep["output_s"]["compose"] > 0 and rep["output_s"]["write"] > 0


@pytest.mark.parametrize("fx", ["tiny", "branch/psum0multi"])
def test_two_shards_and_merge_write_the_golden(fx, tmp_path, monkeypatch):
    from classpro_tpu_torch.io.fastk import open_profiles
    from classpro_tpu_torch.parallel.driver import (merge_shards,
                                                    run_process,
                                                    shard_range)

    _no_records(monkeypatch)
    d = FIX / fx
    out = tmp_path / "o.class"
    a = _args(d)
    for pid in (0, 1):
        run_process(str(d / "reads.fasta.gz"), str(d / "reads"), str(out),
                    2, pid, None, coverage=a.get("coverage", 0),
                    read_len=a.get("read_len", 20000), device="cpu",
                    batch_size=50, _skip_init=True)
    n = open_profiles(str(d / "reads")).nreads
    merge_shards(str(out), 2, [e - b for b, e in
                               (shard_range(n, 2, p) for p in (0, 1))])
    assert out.read_bytes() == _golden(fx)


def test_record_route_paths_are_unchanged(tmp_path):
    """``classify_file_torch`` still yields ClassRecords (the -s route),
    and ``classify -s`` writes the golden through them."""
    from classpro_tpu_torch import cli
    from classpro_tpu_torch.engine import classify_file_torch
    from classpro_tpu_torch.io.classfile import ClassRecord

    d = FIX / "tiny"
    recs = list(classify_file_torch(str(d / "reads.fasta.gz"),
                                    str(d / "reads"), device="cpu"))
    assert all(isinstance(r, ClassRecord) for r in recs)
    assert _text(recs) == _golden("tiny")
    out = tmp_path / "o.class"
    assert cli.main(["classify", "-s", str(d / "reads.fasta.gz"), "-o",
                     str(out), "--device", "cpu"]) == 0
    assert out.read_bytes() == _golden("tiny")
    assert (tmp_path / "o.class.seeds").stat().st_size > 0


# ---------------------------------------------------------------------
# drawn texts


def _drawn_classes(c, rng: random.Random, K: int):
    """Made-up class lines for a reader chunk: reads shorter than K all
    'N' (no buffer), the others K - 1 'N' then E/H/D/R, in two buffers
    at scattered offsets."""
    from classpro_tpu_torch.io.classfile import ChunkClasses

    slen = c.seq_len
    cc = ChunkClasses.none(slen)
    bufs = [bytearray(), bytearray()]
    where = []
    for i, n in enumerate(slen.tolist()):
        if n < K:
            continue
        k = rng.randrange(2)
        bufs[k] += bytes(rng.choice(b"ERHDN") for _ in range(rng.randrange(3)))
        line = b"N" * (K - 1) + bytes(rng.choice(b"ERHD")
                                      for _ in range(n - K + 1))
        where.append((i, k, len(bufs[k])))
        bufs[k] += line
    arrays = [np.frombuffer(bytes(b) or b"\0", np.uint8).copy() for b in bufs]
    for k in (0, 1):
        rows = [(i, o) for i, kk, o in where if kk == k]
        if rows:
            cc.put(np.array([i for i, _ in rows]), arrays[k],
                   np.array([o for _, o in rows]))
    return cc


@settings(max_examples=120, deadline=None)
@given(text=fastx_texts(), gz=st.booleans(), B=st.sampled_from([1, 2, 7, 200]),
       K=st.integers(1, 6), depth=st.integers(1, 3), seed=st.integers(0, 99))
@example(text=F1_TEXT, gz=False, B=1, K=1, depth=1, seed=0)
@example(text=b">r1 \t \nACGT\n> \nA\n>r3\tc d \nAC\r\nGT", gz=True, B=2,
         K=3, depth=1, seed=1)
@example(text=b"@\nAC\n+\nII\n@q2  \n\n+\n\n", gz=False, B=7, K=2, depth=2,
         seed=2)
def test_drawn_texts(text, gz, B, K, depth, seed):
    """The writer over the reader's chunks of a drawn text and made-up
    class lines writes what ``write_class`` writes for the plain reader's
    records (``class_header``: an empty comment is ``(null)``) and the
    same lines, and counts them as the record route does."""
    from classpro_tpu_torch.io.classfile import (ClassRecord, ClassWriter,
                                                 class_header, write_class)
    from classpro_tpu_torch.io.fastx import FastxReader, _read_fastx_plain

    from unittest import mock

    from classpro_tpu_torch.io import classfile

    rng = random.Random(seed)
    with tempfile.TemporaryDirectory() as d, \
            mock.patch.object(classfile, "WRITER_DEPTH", depth):
        p = pathlib.Path(d) / ("x.fx" + (".gz" if gz else ""))
        p.write_bytes(gzip.compress(text) if gz else text)
        lines = []
        with ClassWriter(str(pathlib.Path(d) / "w.class")) as w, \
                FastxReader(str(p)) as rd:
            while (c := rd.next_chunk(B)) is not None:
                cc = _drawn_classes(c, rng, K)
                lines += cc.strs()
                w.put(c, cc)
        plain = list(_read_fastx_plain(str(p)))
        write_class(str(pathlib.Path(d) / "r.class"),
                    [ClassRecord(class_header(r.name, r.comment), r.seq, cl)
                     for r, cl in zip(plain, lines)])
        got = (pathlib.Path(d) / "w.class").read_bytes()
        assert got == (pathlib.Path(d) / "r.class").read_bytes()
        assert (w.reads, w.kmers) == (len(plain), sum(
            len(cl) - cl.count("N") for cl in lines))


# ---------------------------------------------------------------------
# errors


def test_cli_to_a_full_device_exits_1(tmp_path, capsys):
    """ENOSPC from write(2): classify exits 1 with one stderr line."""
    from classpro_tpu_torch import cli

    if not os.path.exists("/dev/full"):
        pytest.skip("no /dev/full on this system")
    rc = cli.main(["classify", str(FIX / "tiny" / "reads.fasta.gz"), "-o",
                   "/dev/full", "--device", "cpu"])
    assert rc == 1
    assert os.strerror(errno.ENOSPC) in capsys.readouterr().err


@pytest.mark.parametrize("fail_at", [0, 1])
def test_write_error_raises_on_the_caller(fail_at, tmp_path, monkeypatch):
    """EIO on the writer thread's write of chunk ``fail_at`` raises on
    the caller's thread (at a later put or at close) through
    ``write_chunks``; no chunk after it is written, the file is closed."""
    from classpro_tpu_torch.engine import write_chunks
    from classpro_tpu_torch.io import classfile

    eng, chunks = _engine("tiny", batch=40)
    calls = []
    real = os.write

    def write(fd, data):
        calls.append(len(data))
        if len(calls) > fail_at:
            raise OSError(errno.EIO, os.strerror(errno.EIO))
        return real(fd, data)
    monkeypatch.setattr(classfile.os, "write", write)
    closed = []
    real_close = os.close
    monkeypatch.setattr(classfile.os, "close",
                        lambda fd: (closed.append(fd), real_close(fd)))
    with pytest.raises(OSError) as e:
        write_chunks(str(tmp_path / "o.class"), eng, chunks())
    assert e.value.errno == errno.EIO
    assert len(calls) == fail_at + 1 and len(closed) == 1


def test_serve_job_write_error_raises(monkeypatch, tmp_path):
    from classpro_tpu_torch import serve

    if not os.path.exists("/dev/full"):
        pytest.skip("no /dev/full on this system")
    with pytest.raises(OSError) as e:
        serve._do_classify({"source": str(FIX / "tiny" / "reads.fasta.gz"),
                            "output": "/dev/full"}, torch.device("cpu"))
    assert e.value.errno == errno.ENOSPC


def test_compose_error_raises(tmp_path):
    """A chunk whose class lines are not its reads' lengths, or not one a
    read, raises on close; nothing of it is written."""
    from classpro_tpu_torch.io.classfile import ChunkClasses
    from classpro_tpu_torch.io.classfile import ClassWriter
    from classpro_tpu_torch.io.fastx import FastxReader

    p = tmp_path / "x.fa"
    p.write_bytes(b">a\nACGT\n>b\nAC\n")
    with FastxReader(str(p)) as rd:
        c = rd.next_chunk(10)
    bad = ChunkClasses.none([4, 3])
    with pytest.raises(ValueError, match="read 1's class line"):
        with ClassWriter(str(tmp_path / "o.class")) as w:
            w.put(c, bad)
    assert (tmp_path / "o.class").read_bytes() == b""
    with pytest.raises(ValueError, match="2 reads came with 1 class"):
        with ClassWriter(str(tmp_path / "o.class")) as w:
            w.put(c, ChunkClasses.none([4]))
    for bad in (ChunkClasses(np.array([0, -1], np.int32),
                             np.array([1, 0]), np.array([4, 2]),
                             [np.zeros(4, np.uint8)]),
                ChunkClasses(np.array([0, -1], np.int32), np.array([0, 0]),
                             np.array([4, 2]), [np.zeros(8, np.uint16)])):
        with pytest.raises(ValueError, match="class (line|buffer)"):
            with ClassWriter(str(tmp_path / "o.class")) as w:
                w.put(c, bad)
    w = ClassWriter(str(tmp_path / "o.class"))
    w.put(c, ChunkClasses.none([4, 2]))
    w.close()
    with pytest.raises(ValueError, match="closed"):
        w.put(c, ChunkClasses.none([4, 2]))
    assert (tmp_path / "o.class").read_bytes() == (
        b"@a (null)\nACGT\n+\nNNNN\n@b (null)\nAC\n+\nNN\n")


def test_writers_under_thread_stress(tmp_path):
    """Twelve writers (more than the cores) on twelve threads, a chunk of
    one to three reads at a time through a queue of one, the interpreter
    switching threads every 10 us: each file is its own chunks, in
    order."""
    import sys
    import threading
    from unittest import mock

    from classpro_tpu_torch.io.classfile import ChunkClasses
    from classpro_tpu_torch.io import classfile
    from classpro_tpu_torch.io.fastx import FastxReader

    src = tmp_path / "x.fa"
    src.write_bytes(b"".join(b">r%d c\nACGTACG\n" % i for i in range(600)))
    rng, chunks = random.Random(0), []
    with FastxReader(str(src)) as rd:
        while (c := rd.next_chunk(rng.randint(1, 3))) is not None:
            chunks.append(c)
    want = []
    for i, c in enumerate(chunks):
        line = b"NNE" + b"HDRE"[i % 4: i % 4 + 1] * 4
        want += [b"@%s c\nACGTACG\n+\n%s\n" % (nm.encode(), line)
                 for nm, _ in c.names()]
    lines = [np.frombuffer(b"NNE" + b"HDRE"[i % 4: i % 4 + 1] * 4,
                           np.uint8).copy() for i in range(len(chunks))]
    errors = []

    def one(k):
        try:
            with classfile.ClassWriter(str(tmp_path / f"{k}.class")) as w:
                for i, c in enumerate(chunks):
                    cc = ChunkClasses.none(c.seq_len)
                    cc.put(np.arange(c.n), lines[i], np.zeros(c.n, np.int64))
                    w.put(c, cc)
        except BaseException as e:  # reported on the test's thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with mock.patch.object(classfile, "WRITER_DEPTH", 1):
            ths = [threading.Thread(target=one, args=(k,)) for k in range(12)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(120)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(th.is_alive() for th in ths)
    for k in range(12):
        assert (tmp_path / f"{k}.class").read_bytes() == b"".join(want)


def test_no_fallback_without_the_host_library(tmp_path, monkeypatch):
    from classpro_tpu_torch import native
    from classpro_tpu_torch.io.classfile import ClassWriter

    def fail(*a, **kw):
        raise OSError("host library unavailable")
    monkeypatch.setattr(native, "get_lib", fail)
    with pytest.raises(OSError, match="host library unavailable"):
        ClassWriter(str(tmp_path / "o.class"))


# ---------------------------------------------------------------------
# the class buffers' lifetime


def _poisoned_buffers(monkeypatch) -> list:
    """Every class buffer ``finish_batch`` and ``expand_rows`` return is
    made a view whose last reference going poisons its bytes ('#'); the
    memory stays mapped (the test holds it).  Returns the finalizers."""
    from classpro_tpu_torch.native import NativeWall

    held, fins = [], []

    def tracked(fn):
        def g(*a, **kw):
            buf = fn(*a, **kw)
            base = buf.copy()
            view = base[:]
            held.append(base)
            fins.append(weakref.finalize(view, base.fill, ord("#")))
            return view
        return g
    for name in ("finish_batch", "expand_rows"):
        monkeypatch.setattr(NativeWall, name,
                            tracked(getattr(NativeWall, name)))
    return fins


def _gated_writer(monkeypatch):
    """The writer thread waits, before its first chunk, for the returned
    event (set once the stream is over and the test has dropped its own
    references, so the writer's queue is all that holds the chunks)."""
    import threading

    from classpro_tpu_torch.io import classfile

    # a queue that holds the whole stream while the writer waits
    monkeypatch.setattr(classfile, "WRITER_DEPTH", 64)
    gate = threading.Event()
    real = classfile.ClassWriter._write

    def gated(self, c, classes):
        assert gate.wait(120)
        return real(self, c, classes)
    monkeypatch.setattr(classfile.ClassWriter, "_write", gated)
    return gate


def _write_gated(fx: str, alldev: bool, out, gate, wrap=lambda cc: cc):
    """``write_chunks``'s loop over ``fx`` in chunks of 20 (12 chunks on
    tiny: a sort window of 8 and one of 4), the writer gated until the
    stream is over; ``wrap`` is what the writer is given of each chunk's
    ChunkClasses."""
    from classpro_tpu_torch.engine import chunk_classes
    from classpro_tpu_torch.io.classfile import ClassWriter

    eng, chunks = _engine(fx, alldev, batch=20)
    with ClassWriter(str(out)) as w:
        for c, cc in chunk_classes(eng, chunks(), buffers=True):
            w.put(c, wrap(cc))
        del c, cc
        gc.collect()
        gate.set()
    return w


@pytest.mark.parametrize("alldev", [False, True], ids=["main", "alldev"])
def test_class_buffers_held_until_written(alldev, tmp_path, monkeypatch):
    """With every class buffer poisoned when released and the writer held
    back until the stream is over, the file is still the golden: the
    writer's queue alone keeps each chunk's buffers until it is written;
    and every buffer is released once the file is written."""
    fins = _poisoned_buffers(monkeypatch)
    gate = _gated_writer(monkeypatch)
    out = tmp_path / "o.class"
    w = _write_gated("tiny", alldev, out, gate)
    assert out.read_bytes() == _golden("tiny")
    assert w.reads == 221
    gc.collect()
    assert len(fins) >= 12 and not any(f.alive for f in fins)


def test_early_release_is_caught(tmp_path, monkeypatch):
    """A writer that queues a chunk's line addresses but drops its
    buffers writes poison: the lifetime check above fails on it."""
    class Addresses:
        """A chunk's line addresses without the buffers behind them."""

        def __init__(self, cc):
            self._addrs, self.length, self._n = cc.addrs(), cc.length, len(cc)

        def addrs(self):
            return self._addrs

        def __len__(self):
            return self._n

    fins = _poisoned_buffers(monkeypatch)
    gate = _gated_writer(monkeypatch)
    out = tmp_path / "o.class"
    _write_gated("tiny", False, out, gate, Addresses)
    got, want = out.read_bytes(), _golden("tiny")
    assert len(got) == len(want) and got != want
    assert b"#" * 100 in got and not any(f.alive for f in fins)
