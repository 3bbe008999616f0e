"""The all-device path's host feed in C++ (``NativeWall.pack_chunk`` on
``cp_pack_chunk``, ``NativeWall.expand_rows`` on ``cp_expand_rows``)
against its plain versions, on the CPU.

- The blobs and dims equal the port's numpy ``pack.pack_chunk`` and the
  JAX package's ``engine.pack_chunk`` on every chunk, ``fblob`` compared
  as uint64 bit patterns, at T = 1 and T = 8: tiny, the first 400 reads
  of medium, every branch/* fixture, eight ``devtools.fuzzgen`` sets and
  a ``devtools.soak.generate`` set at K = 28 and 83x.  On the same chunks
  the C++ expansion equals ``pack.expand_asgn`` byte for byte, the
  assignments drawn over the whole int8 range (-128, -1, 4 and 127
  planted).
- Edge chunks made here: no rel read (R = 8, max_m = 32), a single read,
  reads with no record among the rows, max_n exactly a multiple of 32,
  rows of equal min(cb, ce) keys (the stable order), and -inf, -0.0,
  NaN and counts above 32767 in the records.
- A count below 0 where a log-factorial is read, an n_rel that is not
  the read's is_rel count, a record with e < b and a class line of the
  wrong length raise.
- The entries' worker pool: concurrent callers and a forked child get
  the one-worker bytes.
- ``TorchEngine(alldev=True, device="cpu")`` calls neither numpy
  function, writes the golden bytes on tiny, medium and branch/*, and
  equals the same engine with the numpy feed swapped in here.
Tolerance: bit and byte equality.
"""
import gzip
import pathlib
import shutil
import tempfile

import numpy as np
import pytest
import torch

from test_torch_kernel_shim import _load

torch.set_num_threads(1)

FIX = pathlib.Path(__file__).parent / "fixtures"
BRANCH = sorted(p.name for p in (FIX / "branch").iterdir() if p.is_dir())
# devtools.fuzzgen sets (mode, seed): K 16 / 24 / 32 / 32 for the plain
# seeds, FASTA, FASTQ, plain and gzip; the generators of parity_fuzz
FUZZ = (("plain", 1000), ("plain", 1005), ("plain", 1009), ("plain", 1002),
        ("extreme", 1003), ("cap", 1006), ("ndense", 1008),
        ("random", 1011))
# test_torch_guard_batch.py's 83x set: ~210 reads of ~12 kb
SOAK = dict(gbp=0.0025, kmer=28, cov=83, seed=11)
THREADS = (1, 8)
PLANTED = (-128, -1, 4, 127)

_DATA: dict = {}


def _dataset(name: str):
    """(gm, seqs, profiles) of a dataset, made once per process."""
    if name in _DATA:
        return _DATA[name]
    if name == "medium":
        data = _load("medium", 400)
    elif name.startswith(("fuzz", "soak")):
        from classpro_tpu_torch.devtools import fuzzgen, soak
        from classpro_tpu_torch.estimation import build_global_model
        from classpro_tpu_torch.io.fastk import load_histogram, open_profiles
        from classpro_tpu_torch.io.fastx import read_fastx

        d = tempfile.mkdtemp(prefix="cpfeed")
        try:
            if name == "soak":
                soak.generate(d, SOAK["gbp"], seed=SOAK["seed"],
                              kmer=SOAK["kmer"], cov=SOAK["cov"])
                fname = "reads.fasta"
            else:
                mode, seed = name.split("/")[1:]
                _, fname = fuzzgen.build(int(seed), d,
                                         gen=fuzzgen.GENERATORS.get(mode),
                                         ndense=mode == "ndense")
            root = f"{d}/reads"
            P = open_profiles(root)
            seqs = [r.seq for r in read_fastx(f"{d}/{fname}")]
            data = (build_global_model(load_histogram(root)), seqs,
                    [P.fetch(i) for i in range(len(seqs))])
        finally:
            shutil.rmtree(d, ignore_errors=True)
    else:
        data = _load(name)
    _DATA[name] = data
    return data


def _staged(wall, seqs, profs, B=200):
    """Each chunk of B reads through the C++ wall stage as
    ``TorchEngine._stage`` runs it (reads with a profile, by profile
    length): (seqs, slab, slot, n_out, n_rel, plens, rows), plens and
    seqs in slab order, rows the slab reads with records."""
    for lo in range(0, len(seqs), B):
        S, P = seqs[lo:lo + B], profs[lo:lo + B]
        g = sorted((i for i in range(len(S)) if len(P[i])),
                   key=lambda i: len(P[i]))
        if not g:
            continue
        slab, n_out, n_rel, slot = wall.wall_stage_slab(
            [S[i].encode("ascii") for i in g], [P[i] for i in g], threads=2)
        yield ([S[i] for i in g], slab, slot, n_out, n_rel,
               np.array([len(P[i]) for i in g], np.int64),
               np.flatnonzero(n_out > 0).astype(np.int32))


def _ivs(slab, slot, n_out):
    return [slab[r * slot: r * slot + int(n_out[r])]
            for r in range(len(n_out))]


def _jax_pack():
    """The JAX package's pack_chunk, JAX held on the CPU.  Imported here,
    not with the module: the fork test imports this module in a process
    that must hold no JAX threads."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from classpro_tpu.tpu.engine import pack_chunk

    return pack_chunk


def _check_pack(wall, slab, slot, n_out, n_rel, plens, rows, threads):
    """The C++ blobs against both plain versions; returns numpy's pack."""
    from classpro_tpu_torch.pack import pack_chunk

    jax_pack = _jax_pack()

    ivs = _ivs(slab, slot, n_out)
    want = pack_chunk([int(r) for r in rows], ivs, plens)
    jfb, jib, jdims, _ = jax_pack([int(r) for r in rows], ivs, None, plens)
    fb, ib, dims = wall.pack_chunk(slab, slot, n_out, n_rel, plens, rows,
                                   threads=threads)
    assert dims == want[2] == jdims
    assert ib.dtype == np.int32 and fb.dtype == np.float64
    np.testing.assert_array_equal(ib, want[1])
    np.testing.assert_array_equal(ib, jib)
    np.testing.assert_array_equal(fb.view(np.uint64), want[0].view(np.uint64))
    np.testing.assert_array_equal(fb.view(np.uint64), jfb.view(np.uint64))
    return want


def _check_expand(wall, slab, slot, n_out, rows, want, K, threads, seed):
    """The C++ class lines against ``expand_asgn`` on the packed result's
    layout ((Bn, max_n + 1) bytes, the flag column last), assignments
    drawn over the int8 range with PLANTED in every live row."""
    from classpro_tpu_torch.pack import expand_asgn

    Bn, max_n = want[2][:2]
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 256, size=(Bn, max_n + 1)).astype(np.uint8)
    asgn = buf[:, :-1].view(np.int8)
    for r in range(len(rows)):
        n = int(n_out[rows[r]])
        cols = rng.choice(n, size=min(n, len(PLANTED)), replace=False)
        asgn[r, cols] = PLANTED[:len(cols)]
    res = [None] * len(n_out)
    expand_asgn(asgn, want[3], res, K)
    lines = [res[r] for r in rows]
    out_off = np.zeros(len(rows) + 1, np.int64)
    out_off[1:] = np.cumsum([len(c) for c in lines])
    got = wall.expand_rows(slab, slot, n_out, rows, asgn, out_off,
                           threads=threads)
    assert got.tobytes() == "".join(lines).encode("ascii")
    return lines


DATASETS = (["tiny", "medium", "soak"] + [f"branch/{b}" for b in BRANCH]
            + [f"fuzz/{m}/{s}" for m, s in FUZZ])


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("name", DATASETS)
def test_pack_and_expand_equal_numpy_and_jax(name, threads):
    from classpro_tpu_torch.native import NativeWall

    gm, seqs, profs = _dataset(name)
    wall = NativeWall(gm)
    chunks = 0
    for k, (S, slab, slot, n_out, n_rel, plens, rows) in enumerate(
            _staged(wall, seqs, profs)):
        if not rows.size:
            continue
        want = _check_pack(wall, slab, slot, n_out, n_rel, plens, rows,
                           threads)
        lines = _check_expand(wall, slab, slot, n_out, rows, want, gm.kmer,
                              threads, seed=k)
        # the wall stage's records tile each read: K - 1 + plen bytes
        assert [len(c) for c in lines] == [len(S[r]) for r in rows]
        chunks += 1
    assert chunks >= (2 if name in ("medium", "tiny") else 1)


# ------------------------------------------------------------ edge chunks
def _synthetic(ns, seed, rel_p=0.4, key_hi=50, specials=False):
    """A slab of crafted records: read i has ns[i] records tiling
    [0, plen), random counts (below key_hi, so that min(cb, ce) ties),
    is_rel with probability rel_p (some as 2: any non-zero is rel), and
    with ``specials`` -inf, -0.0, NaN and counts above 32767."""
    from classpro_tpu_torch.native import _IVDT

    rng = np.random.default_rng(seed)
    slot = max(max(ns), 1) + 3
    slab = np.zeros(len(ns) * slot, _IVDT)
    n_rel = np.zeros(len(ns), np.int32)
    plens = np.ones(len(ns), np.int64)
    for i, n in enumerate(ns):
        r = slab[i * slot: i * slot + n]
        lens = rng.integers(1, 60, n)
        r["e"] = np.cumsum(lens)
        r["b"] = r["e"] - lens
        for k in ("cb", "ce", "ccb", "cce"):
            r[k] = rng.integers(0, key_hi, n)
        r["is_rel"] = (rng.random(n) < rel_p) * rng.choice([1, 2], n)
        for k in ("pe", "pe_o_b", "pe_o_e"):
            r[k] = -rng.random(n) * 40
        if specials and n:
            for k in ("pe", "pe_o_b", "pe_o_e"):
                r[k][rng.random(n) < 0.2] = -np.inf
                r[k][rng.random(n) < 0.1] = -0.0
                r[k][rng.random(n) < 0.1] = np.nan
            for k in ("cb", "ce", "ccb", "cce"):
                r[k][rng.random(n) < 0.2] = rng.integers(32767, 40000)
        n_rel[i] = int((r["is_rel"] != 0).sum())
        plens[i] = int(r["e"][-1]) if n else 1
    n_out = np.asarray(ns, np.int32)
    return slab, slot, n_out, n_rel, plens


EDGES = {
    # no rel record anywhere: the rel planes are all padding
    "no_rel": dict(ns=[5, 17, 40, 3], rel_p=0.0),
    "single_read": dict(ns=[23]),
    "single_record": dict(ns=[1]),
    # rows 1 and 4 have no record; the rows still name them
    "empty_rows": dict(ns=[9, 0, 31, 12, 0, 7]),
    # max_n exactly 64 and exactly 32
    "max_n_64": dict(ns=[64, 11, 64, 30]),
    "max_n_32": dict(ns=[32, 32, 1]),
    # keys in [0, 3): long runs of equal min(cb, ce)
    "ties": dict(ns=[150, 97, 64, 5], key_hi=3),
    "specials": dict(ns=[45, 70, 12, 90, 33], specials=True),
    # more rows than one bucket: Bn 16, R 16
    "two_buckets": dict(ns=list(range(1, 13)), rel_p=0.7),
}


@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("case", sorted(EDGES))
def test_edge_chunks(case, threads):
    from classpro_tpu_torch.native import NativeWall

    gm, _, _ = _dataset("tiny")
    wall = NativeWall(gm)
    spec = dict(EDGES[case])
    ns = spec.pop("ns")
    slab, slot, n_out, n_rel, plens = _synthetic(ns, seed=len(ns), **spec)
    rows = np.arange(len(ns), dtype=np.int32)
    want = _check_pack(wall, slab, slot, n_out, n_rel, plens, rows, threads)
    Bn, max_n, R2, max_m = want[2]
    if case == "no_rel":
        assert (R2, max_m) == (16, 32)
    if case.startswith("max_n"):
        assert max_n == max(ns) and max_n % 32 == 0
    if case == "ties":
        cb = want[1][2 * Bn * max_n: 3 * Bn * max_n].reshape(Bn, max_n)
        ce = want[1][3 * Bn * max_n: 4 * Bn * max_n].reshape(Bn, max_n)
        keys = np.minimum(cb, ce)[0, :ns[0]]
        assert len(np.unique(keys)) < ns[0] // 10
    if case == "specials":
        fb = want[0]
        assert np.isnan(fb).any() and np.isneginf(fb).any()
        assert (np.signbit(fb) & (fb == 0)).any()
    live = n_out[rows] > 0
    if not live.all():
        # expand_asgn sizes a record-less row wrongly (np.add.reduceat of
        # an empty segment); the engine never packs one, so the expansion
        # is held on the rows with records
        want = _check_pack(wall, slab, slot, n_out, n_rel, plens,
                           rows[live], threads)
    _check_expand(wall, slab, slot, n_out, rows[live], want, gm.kmer,
                  threads, seed=7)


def test_rows_in_any_order_and_subset():
    """rows is the packing order: a permuted subset of the slab packs as
    numpy packs it, and a row's bytes do not depend on the others'."""
    from classpro_tpu_torch.native import NativeWall

    gm, _, _ = _dataset("tiny")
    wall = NativeWall(gm)
    slab, slot, n_out, n_rel, plens = _synthetic([20, 7, 33, 14, 9, 41],
                                                 seed=3)
    rows = np.array([4, 0, 5, 2], np.int32)
    for T in THREADS:
        want = _check_pack(wall, slab, slot, n_out, n_rel, plens, rows, T)
        _check_expand(wall, slab, slot, n_out, rows, want, gm.kmer, T, 1)


# ------------------------------------------------------- the worker pool
def _medium_chunk():
    from classpro_tpu_torch.native import NativeWall

    gm, seqs, profs = _dataset("medium")
    wall = NativeWall(gm)
    S, slab, slot, n_out, n_rel, plens, rows = next(_staged(wall, seqs,
                                                           profs))
    out_off = np.zeros(len(rows) + 1, np.int64)
    out_off[1:] = np.cumsum([len(S[r]) for r in rows])
    fb, ib, dims = wall.pack_chunk(slab, slot, n_out, n_rel, plens, rows,
                                   threads=1)
    asgn = (np.arange(dims[0] * dims[1]) % 7 - 2).astype(np.int8).reshape(
        dims[:2])
    cls = wall.expand_rows(slab, slot, n_out, rows, asgn, out_off,
                           threads=1)

    def feed(threads):
        f, i, d = wall.pack_chunk(slab, slot, n_out, n_rel, plens, rows,
                                  threads=threads)
        c = wall.expand_rows(slab, slot, n_out, rows, asgn, out_off,
                             threads=threads)
        return (d == dims and np.array_equal(i, ib)
                and np.array_equal(f.view(np.uint64), fb.view(np.uint64))
                and np.array_equal(c, cls))
    return feed


def test_pool_serves_concurrent_callers():
    """Twelve Python threads (more than the cores) feed at once on 2-8
    workers each, with a short switch interval: every call's bytes equal
    the one-worker call's (the pool runs one job at a time)."""
    import sys
    import threading

    feed = _medium_chunk()
    results: list = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=lambda k=k: results.extend(
            feed(2 + k % 7) for _ in range(4))) for k in range(12)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert len(results) == 48 and all(results)


# a child forked after the pool started: run in a process of its own,
# without JAX's threads (os.fork in a process that holds them can hang)
_FORK = r"""
import os, sys
sys.path[:0] = sys.argv[1:3]
from test_torch_pack_native import _medium_chunk
feed = _medium_chunk()
assert feed(8)
pid = os.fork()
if pid == 0:
    ok = False
    try:
        ok = feed(8) and feed(3)
    finally:
        os._exit(0 if ok else 1)
_, status = os.waitpid(pid, 0)
sys.exit(os.waitstatus_to_exitcode(status) or (0 if feed(8) else 3))
"""


def test_pool_in_a_forked_child():
    """A child forked after the pool started (its threads are not in the
    child) feeds on 8 workers of a pool of its own."""
    import subprocess
    import sys

    tests = pathlib.Path(__file__).parent
    r = subprocess.run([sys.executable, "-c", _FORK, str(tests.parent),
                        str(tests)], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]


# ---------------------------------------------------------------- errors
@pytest.mark.parametrize("what", ["cb", "ce", "ccb_rel", "cce_rel"])
def test_negative_count_raises(what):
    from classpro_tpu_torch.native import NativeWall

    gm, _, _ = _dataset("tiny")
    wall = NativeWall(gm)
    slab, slot, n_out, n_rel, plens = _synthetic([12, 30, 8], seed=5,
                                                 rel_p=0.5)
    r = slab[slot: slot + 30]
    k = what.split("_")[0]
    # a rel record for the rel planes' counts; a count of a record that
    # is not rel reaches no log-factorial there
    c = int(np.flatnonzero(r["is_rel"])[0])
    r[k][c] = -1
    with pytest.raises(ValueError, match="below 0"):
        wall.pack_chunk(slab, slot, n_out, n_rel, plens, np.arange(3))
    if what in ("ccb_rel", "cce_rel"):
        r["is_rel"][c] = 0
        n_rel[1] -= 1
        for T in THREADS:    # not read: packs as numpy packs it
            _check_pack(wall, slab, slot, n_out, n_rel, plens,
                        np.arange(3, dtype=np.int32), T)


@pytest.mark.parametrize("delta", [-1, 1])
def test_wrong_n_rel_raises(delta):
    from classpro_tpu_torch.native import NativeWall

    gm, _, _ = _dataset("tiny")
    wall = NativeWall(gm)
    slab, slot, n_out, n_rel, plens = _synthetic([12, 30, 8], seed=6,
                                                 rel_p=0.5)
    n_rel[2] += delta
    with pytest.raises(ValueError, match="n_rel differs"):
        wall.pack_chunk(slab, slot, n_out, n_rel, plens, np.arange(3),
                        threads=8)


@pytest.mark.parametrize("fault", ["e_before_b", "long_line", "short_line"])
def test_expand_errors_raise(fault):
    from classpro_tpu_torch.native import NativeWall

    gm, _, _ = _dataset("tiny")
    wall = NativeWall(gm)
    slab, slot, n_out, n_rel, plens = _synthetic([12, 30, 8], seed=8)
    rows = np.arange(3, dtype=np.int32)
    asgn = np.zeros((8, 32), np.int8)
    out_off = np.zeros(4, np.int64)
    out_off[1:] = np.cumsum(plens + gm.kmer - 1)
    if fault == "e_before_b":
        slab["e"][slot + 4] = slab["b"][slot + 4] - 1
        match = "e < b"
    else:
        out_off[2:] += 1 if fault == "long_line" else -1
        match = "do not fill"
    with pytest.raises(ValueError, match=match):
        wall.expand_rows(slab, slot, n_out, rows, asgn, out_off)


# ---------------------------------------------------------------- engine
def _numpy_feed(eng, monkeypatch):
    """Swap the engine's C++ feed for the numpy plain versions (the feed
    before the C++ entries), with the C++ entries' signatures."""
    from classpro_tpu_torch import pack

    def pack_chunk(slab, slot, n_out, n_rel, plens, rows, threads=0,
                   fblob=None, iblob=None):
        fb, ib, dims, _ = pack.pack_chunk([int(r) for r in rows],
                                          _ivs(slab, slot, n_out), plens)
        if fblob is not None:       # the engine's staging slot
            fblob[:] = fb
            iblob[:] = ib
        return fb, ib, dims

    def expand_rows(slab, slot, n_out, rows, asgn, out_off, threads=0):
        _, _, _, meta = pack.pack_chunk([int(r) for r in rows],
                                        _ivs(slab, slot, n_out),
                                        np.ones(len(n_out), np.int64))
        res = [None] * len(n_out)
        pack.expand_asgn(asgn, meta, res, eng.gm.kmer)
        return np.frombuffer("".join(res[r] for r in rows).encode("ascii"),
                             np.uint8)

    monkeypatch.setattr(eng.wall, "pack_chunk", pack_chunk)
    monkeypatch.setattr(eng.wall, "expand_rows", expand_rows)


def _memo_device_stage(monkeypatch, memo: dict):
    """TorchEngine._device_stage remembered by its inputs' bytes, so that
    the second engine reruns the device stage only on blobs the first
    did not send."""
    from classpro_tpu_torch.engine import TorchEngine

    orig = TorchEngine._device_stage

    def stage(self, fblob, iblob, P, PP, shape):
        key = (fblob.numpy().tobytes(), iblob.numpy().tobytes(), shape)
        if key not in memo:
            memo[key] = orig(self, fblob, iblob, P, PP, shape).clone()
        return memo[key].clone()

    monkeypatch.setattr(TorchEngine, "_device_stage", stage)


def _classes(gm, seqs, profs, numpy_feed, monkeypatch):
    from classpro_tpu_torch.engine import TorchEngine

    eng = TorchEngine(gm, device="cpu", alldev=True)
    with monkeypatch.context() as m:
        if numpy_feed:
            _numpy_feed(eng, m)
        B = eng.batch_size
        chunks = [(seqs[lo:lo + B], profs[lo:lo + B])
                  for lo in range(0, len(seqs), B)]
        return [c for out in eng.classify_stream(iter(chunks), sort_window=8)
                for c in out], eng.guard_flagged


def _golden(name: str, n: int) -> list[str]:
    text = gzip.decompress((FIX / name / "golden.class.gz").read_bytes())
    return text.decode().splitlines()[3::4][:n]


@pytest.mark.parametrize("name", ["tiny", "medium"]
                         + [f"branch/{b}" for b in BRANCH])
def test_engine_feed_is_cpp_and_equals_numpy_feed(name, monkeypatch):
    from classpro_tpu_torch import pack

    gm, seqs, profs = _dataset(name)

    def forbidden(*a, **kw):
        raise AssertionError("the all-device engine ran a numpy feed")

    memo: dict = {}
    _memo_device_stage(monkeypatch, memo)
    with monkeypatch.context() as m:
        m.setattr(pack, "pack_chunk", forbidden)
        m.setattr(pack, "expand_asgn", forbidden)
        got, flagged = _classes(gm, seqs, profs, False, monkeypatch)
    assert got == _golden(name, len(seqs))
    n = len(memo)
    want, wflagged = _classes(gm, seqs, profs, True, monkeypatch)
    assert got == want and flagged == wflagged
    assert len(memo) == n        # the same blobs reached the device
