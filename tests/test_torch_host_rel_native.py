"""The main path's host rel steps after the DP in C++
(``NativeWall.demote_reconcile`` on ``cp_demote_reconcile``) against their
plain versions, on the CPU.

- Random batches (the generator of test_torch_host_steps.py, copied here)
  biased into the rare branches: padding columns holding DIPLO and junk
  states under the no-H rescue, the >=70%-H gate at and just below
  0.7 * m, prefix / suffix rows, hdrr ties, m = 0, m = max_m, max_m = 1
  and the R bucket's padding rows (R = 1024 for more than one worker).
  The C++ entry at T = 1, 2 and 8, its ``v`` a strided view, equals the port's ``rel.reconcile_fwbw(
  rel.demote_host(...))`` and the JAX package's ``device_pipeline`` pair
  byte for byte, padding columns included.
- Crafted pairs, each asserted to take its branch in the plain version:
  the no-H rescue flipping DIPLO at and beyond m, all-H rows (m = max_m),
  the 70% gate exactly at 0.7 * m (m = 10, 20, 30) and one below, a bw
  row demoted only through its reversed planes, the prefix and suffix
  shortcuts (ERROR ends a prefix), an exact hdrr tie and its near miss,
  m = 0, max_m = 1 and the bucket's padding rows.
- An m below 0 or above max_m raises; a zero count in an hdrr ratio gives
  IEEE's pick (the plain version raises ZeroDivisionError there).
- ``classify_file_torch(device="cpu")`` with the numpy pair poisoned writes
  the tiny, medium and branch/* goldens, its C++ host steps equal to the
  numpy pair on every chunk.
Tolerance: byte equality.
"""
import gzip
import json
import pathlib

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)

FIX = pathlib.Path(__file__).parent / "fixtures"
BRANCH = sorted(p.name for p in (FIX / "branch").iterdir() if p.is_dir())
ERROR, REPEAT, HAPLO, DIPLO = 0, 1, 2, 3
THREADS = (1, 2, 8)


# test_torch_host_steps.py's generator, copied
def _batch(rng, R=8, max_m=12):
    m = rng.integers(0, max_m + 1, R)
    gH, gD = int(rng.integers(10, 30)), 0
    gD = 2 * gH - int(rng.integers(-2, 3))
    b = np.zeros((R, max_m), np.int32)
    e = np.ones((R, max_m), np.int32)
    ccb = np.ones((R, max_m), np.int32)
    cce = np.ones((R, max_m), np.int32)
    rel2 = np.zeros((2 * R, max_m), np.int8)
    for j in range(R):
        n = int(m[j])
        starts = np.cumsum(rng.integers(1, 60, n))
        b[j, :n] = starts
        e[j, :n] = starts + rng.integers(1, 50, n)
        centre = rng.choice([gH, gD, (gH + gD) // 2, 3 * gH])
        ccb[j, :n] = np.maximum(rng.integers(centre - 4, centre + 5, n), 1)
        cce[j, :n] = np.maximum(ccb[j, :n] + rng.integers(-3, 4, n), 1)
        if rng.random() < 0.25:    # mean exactly between gH and gD: ties
            ccb[j, :n] = cce[j, :n] = (gH + gD) // 2
        for r in (j, R + j):
            kind = rng.integers(0, 4)
            if kind == 0:      # all H
                row = np.full(n, HAPLO)
            elif kind == 1:    # >= 70% H, rest D/R
                row = np.where(rng.random(n) < 0.8, HAPLO,
                               rng.choice([DIPLO, REPEAT], n))
            elif kind == 2:    # no H: D with some R/E
                row = rng.choice([DIPLO, DIPLO, REPEAT, ERROR], n)
            else:
                row = rng.integers(0, 4, n)
            rel2[r, :n] = row
    rescue = rng.random(2 * R) < 0.5
    return rel2, rescue, b, e, ccb, cce, m.astype(np.int32), gH, gD


def _biased(rng, R=8, max_m=12):
    """A _batch with rows pushed into the rare branches."""
    rel2, rescue, b, e, ccb, cce, m, gH, gD = _batch(rng, R, max_m)
    for j in range(R):
        pick = int(rng.integers(0, 9))
        if pick == 0:            # m = 0 or m = max_m
            m[j] = 0 if rng.random() < 0.5 else max_m
        n = int(m[j])
        if pick == 1 and n < max_m:   # DIPLO and junk beyond m, rescued
            for r in (j, R + j):
                rel2[r, n:] = rng.choice([DIPLO, DIPLO, HAPLO, ERROR,
                                          REPEAT, -1, 7], max_m - n)
            rescue[[j, R + j]] = True
        elif pick == 2 and n:    # n_h at the 70% gate, or one below
            k = max(int(np.ceil(0.7 * n)) - int(rng.integers(0, 2)), 0)
            for r in (j, R + j):
                row = rng.choice([DIPLO, REPEAT], n)
                row[rng.choice(n, k, replace=False)] = HAPLO
                rel2[r, :n] = row
        elif pick == 3 and n:    # a prefix row (REPEAT, states, ERRORs)
            k = int(rng.integers(1, n + 1))
            row = np.zeros(n, np.int8)
            row[0] = REPEAT
            row[1:k] = rng.choice([REPEAT, HAPLO, DIPLO], k - 1)
            if rng.random() < 0.3 and k < n:   # a state after the ERRORs
                row[int(rng.integers(k, n))] = DIPLO
            rel2[j, :n] = row[::-1] if rng.random() < 0.5 else row
        elif pick == 4:          # the R bucket's padding row
            m[j] = 1
            b[j], e[j], ccb[j], cce[j] = 0, 1, 1, 1
            rel2[[j, R + j]] = rng.integers(-2, 6, (2, max_m))
        elif pick == 5 and n >= 4:   # equal hdrr, fw and bw differing
            fw = rng.choice([ERROR, REPEAT], n)
            fw[[0, n - 2]], fw[[1, n - 1]] = DIPLO, HAPLO
            bw = fw.copy()
            bw[2:n - 2] = rng.choice([ERROR, REPEAT], n - 4)
            rel2[j, :n], rel2[R + j, :n] = fw, bw[::-1]
            rescue[[j, R + j]] = False
    return rel2, rescue, b, e, ccb, cce, m, gH, gD


def _strided(rel2):
    """rel2 as a view with a row stride of max_m + 5 bytes (the layout
    ``rel.unpack_out`` hands the engine)."""
    buf = np.full((rel2.shape[0], rel2.shape[1] + 5), 99, np.int8)
    buf[:, :rel2.shape[1]] = rel2
    return buf[:, :rel2.shape[1]]


def _wall():
    from classpro_tpu_torch.native import NativeWall
    from test_torch_kernel_shim import _load

    return NativeWall(_load("tiny", 1)[0])


def _check(wall, args, threads=THREADS):
    """C++ at each T == the port's numpy pair == the JAX package's pair;
    returns the plain version's output."""
    from classpro_tpu.tpu import device_pipeline as J

    from classpro_tpu_torch import rel

    rel2, rescue, b, e, ccb, cce, m, gH, gD = args
    want = rel.reconcile_fwbw(rel.demote_host(*args), ccb, cce, m)
    jax_out = J.reconcile_fwbw(J.demote_host(*args), ccb, cce, m)
    np.testing.assert_array_equal(want, jax_out)
    for T in threads:
        got = wall.demote_reconcile(_strided(rel2), rescue, b, e, ccb, cce,
                                    m, gH, gD, threads=T)
        assert got.dtype == np.int8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want, err_msg=f"T={T}")
    return want


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("shape", [(8, 12), (16, 40), (8, 1), (1024, 10)])
def test_random_batches_equal_numpy_and_jax(seed, shape):
    """(1024, 10): enough pairs for four workers at T = 8 and two at T = 2
    (a worker per 256 pairs); the smaller batches run on the caller."""
    wall = _wall()
    rng = np.random.default_rng(100 * seed + shape[1])
    n = 60 if shape[0] < 256 else 6
    fired = 0
    for _ in range(n):
        args = _biased(rng, *shape)
        want = _check(wall, args)
        fired += int((want != args[0][:shape[0]]).any())
    assert fired > n // 6      # the steps really change rows


# ------------------------------------------------------------- crafted
def _pairs(max_m, rows, gH=20, gD=40):
    """A batch of one pair per (m, fw, bw, rescue, ccb, cce, l) row: fw
    and bw (bw in scan order) fill their rows' first columns, the counts
    and interval lengths l their forward columns (b = 100 * column, e = b
    + l); every other cell keeps pack_rel's padding (b 0, e 1, counts 1)
    or state 0."""
    R = len(rows)
    b = np.zeros((R, max_m), np.int32)
    e = np.ones((R, max_m), np.int32)
    ccb = np.ones((R, max_m), np.int32)
    cce = np.ones((R, max_m), np.int32)
    rel2 = np.zeros((2 * R, max_m), np.int8)
    rescue = np.zeros(2 * R, bool)
    m = np.zeros(R, np.int32)
    for j, (mj, fw, bw, resc, cb, ce, ln) in enumerate(rows):
        m[j] = mj
        rel2[j, :len(fw)], rel2[R + j, :len(bw)] = fw, bw
        rescue[[j, R + j]] = resc
        ccb[j, :len(cb)], cce[j, :len(ce)] = cb, ce
        b[j, :len(ln)] = 100 * np.arange(len(ln))
        e[j, :len(ln)] = b[j, :len(ln)] + np.asarray(ln)
    return rel2, rescue, b, e, ccb, cce, m, gH, gD


H, D, Rp, E = HAPLO, DIPLO, REPEAT, ERROR


def _case(name):
    """(batch, predicate on (input rel2, demoted rel2, output)) of a
    crafted branch."""
    if name == "rescue_beyond_m":      # D -> H below and beyond m
        fw = [D, D, Rp, D, E, D, D, 7]
        bw = [E, D, Rp, D, D, D, D, 7]
        args = _pairs(8, [(5, fw, bw, True, [20] * 5, [20] * 5, [10] * 5)])
        return args, lambda x, d, o: (o[0, 5:7] == H).all() and o[0, 7] == 7
    if name == "all_h_m_max":          # H -> D below m = max_m
        args = _pairs(6, [(6, [H] * 6, [H] * 6, False, [40] * 6, [40] * 6,
                           [10] * 6)])
        return args, lambda x, d, o: (o[0] == D).all()
    if name == "all_h_padding":        # H beyond m is left alone
        args = _pairs(8, [(6, [H] * 8, [H] * 8, False, [40] * 6, [40] * 6,
                           [10] * 6)])
        return args, lambda x, d, o: (o[0, :6] == D).all() \
            and (o[0, 6:] == H).all()
    if name == "seventy_gate":         # n_h == 0.7 * m exactly, one below
        rows = []
        for mj in (10, 20, 30):
            for k in (int(0.7 * mj), int(0.7 * mj) - 1):
                row = [H] * k + [D] * (mj - k)
                rows.append((mj, row, row[::-1], False, [40] * mj,
                             [40] * mj, [10] * mj))
        args = _pairs(30, rows)

        def at_gate(x, d, o):
            R = len(rows)
            return all((d[j] != x[j]).any() == (j % 2 == 0) and
                       (d[R + j] != x[R + j]).any() == (j % 2 == 0)
                       for j in range(R))
        return args, at_gate
    if name == "bw_reversed_planes":   # only the reversed planes demote bw
        fw = [H] * 7 + [D] * 3
        cnt = [20] * 7 + [40] * 3
        args = _pairs(10, [(10, fw, [H] * 7 + [D] * 3, False, cnt, cnt,
                            [10] * 7 + [100] * 3)])
        return args, lambda x, d, o: (d[0] == x[0]).all() \
            and (d[1] != x[1]).any()
    if name == "prefix_keeps_fw":      # hdrr alone would take bw
        fw, bwf = [Rp, H, D, E, E], [D, H, H, E, E]
        args = _pairs(5, [(5, fw, bwf[::-1], False, [1, 1, 4, 1, 1],
                           [1] * 5, [10] * 5)])
        return args, lambda x, d, o: (o[0] == fw).all()
    if name == "error_ends_prefix":    # R H E D E is no prefix row
        fw, bwf = [Rp, H, E, D, E], [D, H, H, E, E]
        args = _pairs(5, [(5, fw, bwf[::-1], False, [1, 1, 1, 4, 1],
                           [1] * 5, [10] * 5)])
        return args, lambda x, d, o: (o[0] == bwf).all()
    if name == "suffix_takes_bw":      # hdrr alone would keep fw
        fw, bwf = [E, E, D, H, Rp], [D, H, H, E, E]
        args = _pairs(5, [(5, fw, bwf[::-1], False, [3, 1, 1, 1, 1],
                           [1] * 5, [10] * 5)])
        return args, lambda x, d, o: (o[0] == bwf).all()
    if name in ("hdrr_tie", "hdrr_near_tie"):  # 1.5 against 0.5 (1.25)
        fw, bwf = [D, H, E, E, E, E], [E, E, E, E, D, H]
        c4 = 1 if name == "hdrr_tie" else 5
        c5 = 2 if name == "hdrr_tie" else 4
        args = _pairs(6, [(6, fw, bwf[::-1], False, [3, 2, 1, 1, c4, c5],
                           [1] * 6, [10] * 6)])
        keep = bwf if name == "hdrr_near_tie" else fw
        return args, lambda x, d, o: (o[0] == keep).all()
    if name == "m_zero":               # nothing below m: fw as it came
        args = _pairs(4, [(0, [D, H, 3, -5], [D, D, -1, 6], True, [], [],
                           [])])
        return args, lambda x, d, o: (o[0] == x[0]).all()
    if name == "max_m_one":
        rows = [(1, [s], [t], r, [c], [c], [10]) for s in (H, D, Rp)
                for t in (H, D) for r in (False, True) for c in (20, 40)]
        args = _pairs(1, rows)
        return args, lambda x, d, o: (o != x[:len(rows)]).any()
    if name == "bucket_padding":       # pack_rel's padding rows (m = 1)
        args = _pairs(4, [(3, [H, H, D], [D, H, H], True, [20] * 3,
                           [20] * 3, [10] * 3)] + [
            (1, [k, 9, -3, D], [D, k, 2, H], True, [1], [1], [1])
            for k in (D, H, E)])
        # the rescued D row flips its D beyond m too; the others stay
        return args, lambda x, d, o: o[1, 0] == o[1, 3] == H \
            and (o[2:] == x[2:4]).all()
    raise KeyError(name)


CASES = ("rescue_beyond_m", "all_h_m_max", "all_h_padding", "seventy_gate",
         "bw_reversed_planes", "prefix_keeps_fw", "error_ends_prefix",
         "suffix_takes_bw", "hdrr_tie", "hdrr_near_tie", "m_zero",
         "max_m_one", "bucket_padding")


@pytest.mark.parametrize("name", CASES)
def test_crafted_branches(name):
    from classpro_tpu_torch import rel

    args, took = _case(name)
    want = _check(_wall(), args)
    assert took(args[0], rel.demote_host(*args), want), name


@pytest.mark.parametrize("bad", [-1, 13])
def test_m_out_of_range_raises(bad):
    rel2, rescue, b, e, ccb, cce, m, gH, gD = _batch(
        np.random.default_rng(7))
    m[3] = bad
    with pytest.raises(ValueError, match="rel row 3"):
        _wall().demote_reconcile(rel2, rescue, b, e, ccb, cce, m, gH, gD,
                                 threads=8)


def test_zero_count_follows_ieee():
    """A zero count in an hdrr ratio: the plain version's Python float
    division raises; the C++ entry takes IEEE's inf and picks bw."""
    from classpro_tpu_torch import rel

    fw, bwf = [D, H, E], [E, D, H]
    args = _pairs(3, [(3, fw, bwf[::-1], False, [1, 0, 2], [1] * 3,
                       [10] * 3)])
    with pytest.raises(ZeroDivisionError):
        rel.reconcile_fwbw(rel.demote_host(*args), args[4], args[5], args[6])
    with np.errstate(divide="ignore"):
        hf = (np.float64(1) / np.float64(0)) / (np.float64(1) / 1)
    hb = (np.float64(0) / np.float64(2)) / (np.float64(1) / 1)
    assert not abs(hf - 1) <= abs(hb - 1)
    got = _wall().demote_reconcile(*args)
    assert (got[0] == bwf).all()


# -------------------------------------------------------------- engine
def _golden_run(name: str, monkeypatch):
    from classpro_tpu_torch import engine as engine_mod
    from classpro_tpu_torch import rel
    from classpro_tpu_torch.native import NativeWall

    plain = (rel.demote_host, rel.reconcile_fwbw)

    def forbidden(*a, **kw):
        raise AssertionError("the engine ran a numpy host rel step")

    monkeypatch.setattr(rel, "demote_host", forbidden)
    monkeypatch.setattr(rel, "reconcile_fwbw", forbidden)
    assert not hasattr(engine_mod, "demote_host")
    assert not hasattr(engine_mod, "reconcile_fwbw")
    cpp = NativeWall.demote_reconcile
    chunks = []

    def checked(self, v, rescue, b, e, ccb, cce, m, gH, gD, threads=0):
        got = cpp(self, v, rescue, b, e, ccb, cce, m, gH, gD, threads)
        want = plain[1](plain[0](np.ascontiguousarray(v), rescue, b, e,
                                 ccb, cce, m, gH, gD), ccb, cce, m)
        np.testing.assert_array_equal(got, want)
        chunks.append(len(m))
        return got

    monkeypatch.setattr(NativeWall, "demote_reconcile", checked)
    d = FIX / name
    args = {}
    if (d / "args.json").exists():
        args = json.loads((d / "args.json").read_text())
    recs = list(engine_mod.classify_file_torch(
        str(d / "reads.fasta.gz"), str(d / "reads"), device="cpu",
        threads=4, **args))
    text = "".join(f"{r.header}\n{r.seq}\n+\n{r.classes}\n" for r in recs)
    return text, gzip.decompress((d / "golden.class.gz").read_bytes()), \
        chunks


@pytest.mark.parametrize("name", ["tiny", "medium"]
                         + [f"branch/{b}" for b in BRANCH])
def test_engine_host_steps_are_cpp(name, monkeypatch):
    text, golden, chunks = _golden_run(name, monkeypatch)
    assert text.encode() == golden
    assert chunks       # every fixture has a chunk with rel reads
