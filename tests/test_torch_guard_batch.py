"""The exactness guard's re-decisions as one batched C++ call
(``NativeWall.exact_rel_batch``, ``cp_exact_rel_batch``) on both paths.

- The batch equals the plain version, ``exact_rel`` one read at a time,
  row for row at threads 1 and 4, on every medium read with rel records
  (all treated as flagged), the fuzz-found tie read (tie8339) and the
  all-dead reads (branch/psum0), the destination rows permuted; and the
  port's Python oracle (exact/rel.py) on the first 100 medium reads and
  those.
- A row it cannot decide raises what ``exact_rel`` raises, naming the
  first failing row in row order whatever the thread count; three
  batches at once, each on as many workers as cores (the Skellam memo is
  one table for the process), keep the plain version's bytes.
- ``TorchEngine._exact_guard`` (row j -> slab read ``live[j]``, padded
  rows skipped) and the all-device guard (slab read r) equal the per-row
  and per-read loops they replace.
- A dataset made here by ``devtools.soak.generate`` at K = 28 and 83x
  (the coverage of a real HiFi run, 30 kb genome, ~210 reads of ~12 kb),
  where the DP's force flags fire on most reads: the port's main path,
  at -T 1 and -T 4, writes the JAX package's ``TpuEngine`` bytes (CPU)
  with its guard_flagged (the all-device path on this dataset:
  test_torch_guard_alldev.py).
Tolerance: byte equality.
"""
import pathlib

import numpy as np
import pytest
import torch

from test_torch_kernel_shim import _load

torch.set_num_threads(1)

FIX = pathlib.Path(__file__).parent / "fixtures"

# a read whose exact rel DP takes log(0) (a Poisson rate of 0 after the
# no-H rescue), found by a seeded search over crafted records on
# medium's model: exact_rel raises ValueError on it, as the oracle does
BAD_READ = [(36, 205, 0, 0, 0, 0, 1, 0, -32.300753994566335, 0.0, 0.0),
            (214, 425, 0, 22, 0, 22, 1, 0, -42.39847150615792, 0.0, 0.0),
            (456, 850, 3, 0, 3, 0, 1, 0, -42.297867196602034, 0.0, 0.0),
            (856, 1179, 23, 24, 23, 24, 1, 0, -42.25715404791007, 0.0, 0.0),
            (1227, 1417, 6, 1, 6, 1, 1, 0, -14.49205749080187, 0.0, 0.0)]


def _staged(fx: str, n=None):
    """(wall, slab, slot, n_out, n_rel, plens) of a fixture's reads
    through the C++ wall stage, in input order."""
    from classpro_tpu_torch.native import NativeWall

    gm, seqs, profs = _load(fx, n)
    wall = NativeWall(gm)
    slab, n_out, n_rel, slot = wall.wall_stage_slab(
        [s.encode("ascii") for s in seqs], profs, threads=2)
    return wall, slab, slot, n_out, n_rel, np.array([len(p) for p in profs])


def _rel_recs(slab, slot, n_out, i):
    recs = slab[i * slot: i * slot + int(n_out[i])]
    return recs[recs["is_rel"] != 0]


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("fx", ["medium", "tie8339", "branch/psum0"])
def test_batch_equals_single_row_by_row(fx, threads):
    wall, slab, slot, n_out, n_rel, plens = _staged(fx)
    live = np.nonzero(n_rel > 0)[0]
    assert live.size > (300 if fx == "medium" else 0)
    max_m = int(n_rel.max()) + 3
    want = np.full((live.size, max_m), -7, np.int8)
    for j, i in enumerate(live):
        want[j, :n_rel[i]] = wall.exact_rel(
            _rel_recs(slab, slot, n_out, i), int(plens[i]))
    # destination rows reversed: row k of the batch lands in rel_out row
    # len - 1 - k, and untouched cells keep their bytes
    rows = np.arange(live.size)[::-1]
    got = np.full((live.size, max_m), -7, np.int8)
    wall.exact_rel_batch(slab, slot, n_out, live, plens[live], got, rows,
                         threads=threads)
    np.testing.assert_array_equal(got[::-1], want)


@pytest.mark.parametrize("fx,n", [("medium", 100), ("tie8339", None),
                                  ("branch/psum0", None)])
def test_batch_matches_python_oracle(fx, n):
    """The batch on 4 workers (the port's C++ copy, its Skellam memo one
    table for the process) equals the port's Python oracle,
    exact/rel.py, on every row: the exact tie of tie8339 and the
    all-dead reads of branch/psum0 among them."""
    from classpro_tpu_torch.exact.rel import RelClassifier
    from classpro_tpu_torch.exact.wall import Intvl

    wall, slab, slot, n_out, n_rel, plens = _staged(fx, n)
    live = np.nonzero(n_rel > 0)[0]
    got = np.zeros((live.size, int(n_rel.max())), np.int8)
    wall.exact_rel_batch(slab, slot, n_out, live, plens[live], got,
                         np.arange(live.size), threads=4)
    for j, i in enumerate(live):
        rels = [Intvl(b=int(r["b"]), e=int(r["e"]), cb=int(r["cb"]),
                      ce=int(r["ce"]), ccb=int(r["ccb"]), cce=int(r["cce"]),
                      is_rel=True, pe=float(r["pe"]),
                      pe_o_b=float(r["pe_o_b"]), pe_o_e=float(r["pe_o_e"]))
                for r in _rel_recs(slab, slot, n_out, i)]
        RelClassifier(wall.gm).classify(rels, rels, int(plens[i]))
        np.testing.assert_array_equal(got[j, :n_rel[i]],
                                      [I.asgn for I in rels])


@pytest.mark.parametrize("threads", [1, 4])
def test_batch_raises_as_single(threads):
    from classpro_tpu_torch.native import _IVDT

    wall, slab, slot, n_out, n_rel, plens = _staged("medium", 40)
    bad = np.array(BAD_READ, _IVDT)
    with pytest.raises(ValueError) as single:
        wall.exact_rel(bad, 1500)
    # the crafted read replaces reads 5 and 17 of the slab
    for i in (5, 17):
        slab[i * slot: i * slot + len(bad)] = bad
        n_out[i] = len(bad)
    live = np.nonzero(n_out > 0)[0]
    rel_out = np.zeros((live.size, 256), np.int8)
    with pytest.raises(ValueError) as batch:
        wall.exact_rel_batch(slab, slot, n_out, live, np.full(live.size,
                                                              1500),
                             rel_out, np.arange(live.size), threads=threads)
    k = int(np.nonzero(live == 5)[0][0])
    assert str(batch.value) == f"read 5 (batch row {k}): {single.value}"
    # the rows before and after the failing ones were still re-decided
    i = int(live[-1])
    np.testing.assert_array_equal(
        rel_out[-1, :n_rel[i]],
        wall.exact_rel(_rel_recs(slab, slot, n_out, i), 1500))


def test_batch_shared_memo_under_contention():
    """The Skellam memo is one table for the process: three batches at
    once, each asking for 16 workers (capped at the machine's cores, so
    three times as many workers as cores), give the plain version's
    bytes on every row, call after call."""
    import threading

    wall, slab, slot, n_out, n_rel, plens = _staged("medium")
    live = np.nonzero(n_rel > 0)[0]
    max_m = int(n_rel.max())
    want = np.zeros((live.size, max_m), np.int8)
    for j, i in enumerate(live):
        want[j, :n_rel[i]] = wall.exact_rel(
            _rel_recs(slab, slot, n_out, i), int(plens[i]))
    bad: list = []

    def worker(seed):
        order = np.random.default_rng(seed).permutation(live.size)
        for _ in range(3):
            got = np.zeros_like(want)
            wall.exact_rel_batch(slab, slot, n_out, live[order],
                                 plens[live[order]], got, order, threads=16)
            if not np.array_equal(got, want):
                bad.append(seed)

    ts = [threading.Thread(target=worker, args=(s,)) for s in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    assert not bad


def test_batch_refuses_bad_arguments():
    wall, slab, slot, n_out, n_rel, plens = _staged("tiny", 8)
    live = np.nonzero(n_rel > 0)[0]
    args = (slab, slot, n_out, live, plens[live])
    with pytest.raises(ValueError, match="C-contiguous int8"):
        wall.exact_rel_batch(*args, np.zeros((live.size, 64), np.int16),
                             np.arange(live.size))
    with pytest.raises(IndexError):
        wall.exact_rel_batch(*args, np.zeros((1, 64), np.int8),
                             np.arange(live.size))
    with pytest.raises(ValueError, match="more rel records"):
        wall.exact_rel_batch(*args, np.zeros((live.size, 1), np.int8),
                             np.arange(live.size))
    with pytest.raises(ValueError, match="wall slab"):
        wall.exact_rel_batch(slab["b"], *args[1:],
                             np.zeros((live.size, 64), np.int8),
                             np.arange(live.size))


@pytest.mark.parametrize("threads", [1, 4])
def test_main_guard_maps_rows_to_live_reads(threads):
    """_exact_guard with every row flagged (R padded past the live rows)
    writes the per-row loop's bytes, row j from slab read live[j]."""
    from classpro_tpu_torch.engine import TorchEngine, _bucket

    gm, seqs, profs = _load("medium", 150)
    eng = TorchEngine(gm, device="cpu", threads=threads)
    st = eng._stage(seqs, profs)
    slab, slot, n_out, n_rel = st["slab"], st["slot"], st["n_out"], \
        st["n_rel"]
    live = np.nonzero(n_rel > 0)[0]
    R = _bucket(live.size)
    assert R > live.size
    max_m = int(n_rel.max())
    rel_out = np.full((R, max_m), 9, np.int8)
    want = rel_out.copy()
    for j, i in enumerate(live):
        want[j, :n_rel[i]] = eng.wall.exact_rel(
            _rel_recs(slab, slot, n_out, i), int(st["_plens"][i]))
    st["risky"] = np.ones(2 * R, bool)
    st["mm"] = np.full(R, 1e-30, np.float32)
    eng._exact_guard(st, rel_out)
    np.testing.assert_array_equal(rel_out, want)
    assert eng.guard_flagged == R


@pytest.mark.parametrize("threads", [1, 4])
def test_alldev_guard_maps_slab_reads(threads):
    """The all-device guard over a chunk's reads (those without rel
    records among them) writes what each read's own exact_rel and
    one-read finish_batch gave, in the order asked."""
    from classpro_tpu_torch.engine import TorchEngine

    gm, seqs, profs = _load("medium", 120)
    eng = TorchEngine(gm, device="cpu", alldev=True, threads=threads)
    st = eng._stage(seqs, profs)
    slab, slot, n_out, n_rel = st["slab"], st["slot"], st["n_out"], \
        st["n_rel"]
    rs = np.nonzero(n_out > 0)[0][::-1]       # descending slab order
    # two reads lose their rel records: their rows take no rel row
    for r in rs[3:5]:
        base = r * slot
        slab["is_rel"][base: base + n_out[r]] = 0
        n_rel[r] = 0

    def one(r):
        recs = slab[r * slot: (r + 1) * slot]
        rel_recs = _rel_recs(slab, slot, n_out, r)
        rel_out = None
        if n_rel[r] > 0:
            plen = len(st["profiles"][st["g"][r]])
            rel_out = eng.wall.exact_rel(rel_recs, plen)[None, :]
        out_off = np.array([0, len(st["seqs"][st["g"][r]])], np.int64)
        buf = eng.wall.finish_batch(recs, slot, n_out[r:r + 1],
                                    n_rel[r:r + 1], rel_out,
                                    max(len(rel_recs), 1), out_off,
                                    threads=1)
        return str(memoryview(buf), "ascii")

    buf, off = eng._exact_alldev(st, rs)
    mv = memoryview(buf)
    assert [str(mv[o: o + len(st["seqs"][st["g"][r]])], "ascii")
            for r, o in zip(rs, off)] == [one(r) for r in rs]


# ---------------------------------------------------------------------
# the 83x dataset
SOAK = dict(gbp=0.0025, kmer=28, cov=83, seed=11)


@pytest.fixture(scope="module")
def soak83(tmp_path_factory):
    """(root, seqs, profiles) of the generated dataset."""
    from classpro_tpu_torch.devtools.soak import generate
    from classpro_tpu_torch.io.fastk import open_profiles
    from classpro_tpu_torch.io.fastx import read_fastx

    d = tmp_path_factory.mktemp("soak83")
    meta = generate(str(d), SOAK["gbp"], seed=SOAK["seed"],
                    kmer=SOAK["kmer"], cov=SOAK["cov"])
    root = str(d / "reads")
    P = open_profiles(root)
    seqs = [r.seq for r in read_fastx(root + ".fasta")]
    assert len(seqs) == meta["n_reads"] <= 250
    assert int(SOAK["gbp"] * 1e9 / SOAK["cov"]) >= 30_000
    return root, seqs, [P.fetch(i) for i in range(len(seqs))]


def _chunks(seqs, profs, B=200):
    return ((seqs[lo:lo + B], profs[lo:lo + B])
            for lo in range(0, len(seqs), B))


@pytest.fixture(scope="module")
def jax_main(soak83):
    """The JAX package's TpuEngine (main path, CPU): (classes,
    guard_flagged)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram
    from classpro_tpu.tpu.engine import TpuEngine

    root, seqs, profs = soak83
    eng = TpuEngine(build_global_model(load_histogram(root)))
    out = [c for o in eng.classify_stream(_chunks(seqs, profs),
                                          sort_window=8) for c in o]
    return out, eng.guard_flagged


def _port(soak83, alldev: bool, threads: int, n=None, B=200):
    from classpro_tpu_torch.engine import TorchEngine
    from classpro_tpu_torch.estimation import build_global_model
    from classpro_tpu_torch.io.fastk import load_histogram

    root, seqs, profs = soak83
    eng = TorchEngine(build_global_model(load_histogram(root)),
                      batch_size=B, device="cpu", alldev=alldev,
                      threads=threads)
    out = [c for o in eng.classify_stream(
        _chunks(seqs[:n], profs[:n], B), sort_window=8) for c in o]
    return out, eng.guard_flagged


@pytest.mark.parametrize("threads", [1, 4])
def test_soak83_main_equals_jax(soak83, jax_main, threads):
    """The main path at -T 1 and -T 4: the JAX engine's bytes and its
    guard_flagged, at least 20% of the reads."""
    out, flagged = _port(soak83, False, threads)
    want, jax_flagged = jax_main
    assert out == want
    assert flagged == jax_flagged >= 0.2 * len(want)
