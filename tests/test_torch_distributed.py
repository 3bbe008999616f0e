"""The port's multi-process shard driver (classpro_tpu_torch.parallel.
driver) on the CPU: every case of test_distributed.py, held against a
single run of the port and the tiny golden (the reference binary's
bytes), and the driver's helpers against the JAX driver's.

Real processes run ``python -m classpro_tpu_torch.parallel.driver`` with
``--device cpu``, so their group is gloo over ``tcp://127.0.0.1``.
"""
import gzip
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from test_torch_mesh import free_port

torch.set_num_threads(1)

FIX = pathlib.Path(__file__).parent / "fixtures"
ROOT = pathlib.Path(__file__).resolve().parent.parent
GOLD = gzip.decompress((FIX / "tiny" / "golden.class.gz").read_bytes())


def _stage_tiny(d):
    src = d / "reads.fasta"
    src.write_bytes(gzip.decompress((FIX / "tiny" / "reads.fasta.gz")
                                    .read_bytes()))
    for fn in ("reads.prof", ".reads.pidx.1", ".reads.prof.1", "reads.hist"):
        (d / fn).write_bytes((FIX / "tiny" / fn).read_bytes())
    return str(src)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The staged tiny dataset and a single-process run of it, which
    must be the golden bytes."""
    from classpro_tpu_torch.parallel.driver import run_process

    d = tmp_path_factory.mktemp("tiny")
    src = _stage_tiny(d)
    single = str(d / "single.class")
    assert run_process(src, None, single, device="cpu") == single
    data = open(single, "rb").read()
    assert data == GOLD
    return src, str(d / "reads"), data


def _expected(fk, nproc):
    from classpro_tpu_torch.io.fastk import open_profiles
    from classpro_tpu_torch.parallel.driver import shard_range

    n = open_profiles(fk).nreads
    return [e - b for b, e in (shard_range(n, nproc, p)
                               for p in range(nproc))]


def test_shard_range_partition():
    from classpro_tpu.parallel.driver import shard_range as jax_range

    from classpro_tpu_torch.parallel.driver import shard_range

    for nreads in (0, 1, 7, 100, 221, 398):
        for nproc in (1, 2, 3, 8):
            spans = [shard_range(nreads, nproc, p) for p in range(nproc)]
            assert spans == [jax_range(nreads, nproc, p)
                             for p in range(nproc)]
            assert spans[0][0] == 0 and spans[-1][1] == nreads
            for (a, b), (c, d) in zip(spans, spans[1:]):
                assert b == c and a <= b and c <= d


def test_helpers_equal_jax_driver(tmp_path):
    """partial_instance_hist and the params stamp are the JAX driver's:
    a shard either driver wrote carries the same stamp."""
    from classpro_tpu.parallel import driver as jd

    from classpro_tpu_torch.io.fastk import open_profiles
    from classpro_tpu_torch.parallel import driver as td

    P = open_profiles(str(FIX / "tiny" / "reads"))
    profs = [P.fetch(i) for i in range(40)] + [np.zeros(0, np.uint16)]
    for low, high in ((1, 32767), (3, 50)):
        np.testing.assert_array_equal(td.partial_instance_hist(profs, low,
                                                               high),
                                      jd.partial_instance_hist(profs, low,
                                                               high))
    model = tmp_path / "m.model"
    model.write_bytes(b"some model bytes")
    for args in (("reads.fasta", 1, 0, 0, 20000, None),
                 ("x/reads.fq.gz", 4, 3, 40, 15000, str(model)),
                 ("reads.fasta", 2, 1, 0, 20000, str(tmp_path / "none"))):
        assert td._params_stamp(*args) == jd._params_stamp(*args)
    for body in (b"", b"@r\nAC\n+\nNN\n", b"@r\nAC\n+\nN", b"@r\nAC\n+\n"):
        p = tmp_path / "s"
        p.write_bytes(body)
        assert td.shard_records(str(p)) == jd.shard_records(str(p))
    assert td.shard_records(str(tmp_path / "missing")) == -1


def test_simulated_two_process_run_matches_single(tiny, tmp_path):
    """The per-process body run twice (pid 0/1) + merge == one run."""
    from classpro_tpu_torch.parallel.driver import merge_shards, run_process

    src, fk, single = tiny
    multi = str(tmp_path / "multi.class")
    for pid in range(2):
        run_process(src, fk, multi, nproc=2, pid=pid, device="cpu",
                    _skip_init=True)
    merge_shards(multi, 2, _expected(fk, 2))
    assert open(multi, "rb").read() == single


def test_psum_estimation_matches_hist_model():
    """The instance histogram summed over shards reproduces the .hist
    model exactly (the JAX test's case; no group: one process)."""
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram, open_profiles
    from classpro_tpu_torch.parallel.driver import (estimate_distributed,
                                                    partial_instance_hist,
                                                    shard_range)

    root = str(FIX / "medium" / "reads")
    hist = load_histogram(root)
    P = open_profiles(root)
    profs = [P.fetch(i) for i in range(P.nreads)]
    gm = estimate_distributed(profs, kmer=hist.kmer, low=hist.low,
                              high=hist.high)
    ref = build_global_model(hist)
    assert (gm.cov == ref.cov).all() and gm.dr_ratio == ref.dr_ratio
    # the shards' partial histograms sum to the whole one
    parts = [partial_instance_hist(profs[b:e], hist.low, hist.high)
             for b, e in (shard_range(len(profs), 3, p) for p in range(3))]
    np.testing.assert_array_equal(sum(parts), partial_instance_hist(
        profs, hist.low, hist.high))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.parametrize("nproc", [2, 4])
def test_real_multi_process_torch_distributed(tiny, tmp_path, nproc):
    """nproc OS processes join a gloo group at a localhost address, run
    driver main() end to end (shard classify, all-reduce barrier, pid-0
    merge with completeness check), and the merged file equals a single
    run; every shard file is merged away."""
    src, fk, single = tiny
    multi = tmp_path / "multi.class"
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "classpro_tpu_torch.parallel.driver", src,
         "-N", fk, "-o", str(multi), "--device", "cpu", "--nproc",
         str(nproc), "--pid", str(pid), "--coord", f"127.0.0.1:{port}"],
        env=_env(), cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for pid in range(nproc)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_so, se) in zip(procs, outs):
        assert p.returncode == 0, se.decode()[-2000:]
    assert multi.read_bytes() == single
    assert not any(os.path.exists(f"{multi}.{p}") for p in range(nproc))


def test_driver_needs_coord_for_several_processes(tiny, tmp_path):
    from classpro_tpu_torch.parallel.driver import run_process

    src, fk, _ = tiny
    with pytest.raises(ValueError, match="--coord"):
        run_process(src, fk, str(tmp_path / "x.class"), nproc=2, pid=0,
                    device="cpu")


def test_shard_resume_kill_and_rerun(tiny, tmp_path):
    """After a 'crash' that leaves shard 0 complete and shard 1 truncated
    mid-record, the merge refuses; a --resume rerun skips shard 0 (file
    untouched), recomputes shard 1, and the merge equals a single run."""
    from classpro_tpu_torch.parallel.driver import (merge_shards,
                                                    run_process,
                                                    shard_records)

    src, fk, single = tiny
    multi = str(tmp_path / "multi.class")
    for pid in range(2):
        run_process(src, fk, multi, nproc=2, pid=pid, device="cpu",
                    _skip_init=True)
    with open(multi + ".1", "r+b") as f:
        f.truncate(os.path.getsize(multi + ".1") - 37)
    expected = _expected(fk, 2)
    assert shard_records(multi + ".0") == expected[0]
    assert shard_records(multi + ".1") != expected[1]
    with pytest.raises(RuntimeError, match="incomplete"):
        merge_shards(multi, 2, expected)

    stat0 = os.stat(multi + ".0")
    for pid in range(2):
        run_process(src, fk, multi, nproc=2, pid=pid, resume=True,
                    device="cpu", _skip_init=True)
    s0 = os.stat(multi + ".0")
    assert (s0.st_mtime_ns, s0.st_ino) == (stat0.st_mtime_ns, stat0.st_ino)
    assert shard_records(multi + ".1") == expected[1]
    merge_shards(multi, 2, expected)
    assert open(multi, "rb").read() == single


def test_resume_rejects_stale_params_shard(tiny, tmp_path):
    """A complete shard made under other parameters is not reused: a
    rerun with -c overridden reclassifies, a rerun with the same
    parameters then skips."""
    from classpro_tpu_torch.parallel.driver import run_process

    src, fk, _ = tiny
    multi = str(tmp_path / "multi.class")
    run_process(src, fk, multi, nproc=2, pid=0, device="cpu",
                _skip_init=True)
    stat0 = os.stat(multi + ".0")
    run_process(src, fk, multi, nproc=2, pid=0, resume=True, coverage=40,
                device="cpu", _skip_init=True)
    s1 = os.stat(multi + ".0")
    assert s1.st_mtime_ns != stat0.st_mtime_ns       # recomputed
    run_process(src, fk, multi, nproc=2, pid=0, resume=True, coverage=40,
                device="cpu", _skip_init=True)
    s2 = os.stat(multi + ".0")
    assert (s2.st_mtime_ns, s2.st_ino) == (s1.st_mtime_ns, s1.st_ino)


def _stage_subset(d, n):
    """The first n tiny reads as a dataset of their own (same .hist, so
    single and sharded runs share one global model)."""
    import itertools

    from classpro_tpu_torch.io.fastk import open_profiles, write_profiles
    from classpro_tpu_torch.io.fastx import read_fastx, write_fasta

    recs = list(itertools.islice(read_fastx(str(FIX / "tiny" /
                                                "reads.fasta.gz")), n))
    write_fasta(str(d / "reads.fasta"),
                [(r.name, r.comment, r.seq) for r in recs])
    P = open_profiles(str(FIX / "tiny" / "reads"))
    write_profiles(str(d / "reads"), [P.fetch(i) for i in range(n)],
                   P.kmer, nparts=1)
    (d / "reads.hist").write_bytes((FIX / "tiny" / "reads.hist")
                                   .read_bytes())
    return str(d / "reads.fasta")


def test_eight_shards_uneven_with_empty_tail(tiny, tmp_path):
    """nproc=8 over 42 reads: shards of 6, so shards 0-6 carry all 42
    reads and shard 7 is EMPTY; every process writes its shard file, the
    checked merge accepts the empty tail, and the result equals a single
    run (the golden's first 42 records)."""
    from classpro_tpu_torch.parallel.driver import (merge_shards,
                                                    run_process,
                                                    shard_records)

    src = _stage_subset(tmp_path, 42)
    fk = str(tmp_path / "reads")
    single = str(tmp_path / "single.class")
    run_process(src, fk, single, device="cpu")
    want = b"".join(tiny[2].split(b"\n")[i] + b"\n" for i in range(4 * 42))
    assert open(single, "rb").read() == want

    expected = _expected(fk, 8)
    assert expected[-1] == 0 and sum(expected) == 42
    multi = str(tmp_path / "multi.class")
    for pid in range(8):
        run_process(src, fk, multi, nproc=8, pid=pid, device="cpu",
                    _skip_init=True)
    assert shard_records(multi + ".7") == 0
    merge_shards(multi, 8, expected)
    assert open(multi, "rb").read() == want


def test_four_shard_resume_after_kill(tiny, tmp_path):
    """Resume at 4 shards: shard 1 truncated mid-record and shard 2
    deleted; --resume recomputes exactly those two, skips 0 and 3, and
    the merge equals a single run."""
    from classpro_tpu_torch.parallel.driver import (merge_shards,
                                                    run_process,
                                                    shard_records)

    src, fk, single = tiny
    multi = str(tmp_path / "multi.class")
    for pid in range(4):
        run_process(src, fk, multi, nproc=4, pid=pid, device="cpu",
                    _skip_init=True)
    with open(multi + ".1", "r+b") as f:
        f.truncate(os.path.getsize(multi + ".1") - 11)
    os.remove(multi + ".2")
    expected = _expected(fk, 4)
    stats = {p: os.stat(f"{multi}.{p}") for p in (0, 3)}
    for pid in range(4):
        run_process(src, fk, multi, nproc=4, pid=pid, resume=True,
                    device="cpu", _skip_init=True)
    for p in (0, 3):
        s = os.stat(f"{multi}.{p}")
        assert (s.st_mtime_ns, s.st_ino) == (stats[p].st_mtime_ns,
                                             stats[p].st_ino)
    for p in (1, 2):
        assert shard_records(f"{multi}.{p}") == expected[p]
    merge_shards(multi, 4, expected)
    assert open(multi, "rb").read() == single
