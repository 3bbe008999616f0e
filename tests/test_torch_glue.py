"""The glue kernels (csrc/glue.cu: the all-device rel_prep, rel_settle),
the DP kernel's first-pass prologue (the main layout's planes,
csrc/prep_cell.cuh, run by kernels.rel_dp_first) and its row tails
(csrc/rel_tail.cuh: the rescue predicate and the pack, run by
kernels.rel_dp_first, rel_dp_rescue and rel_dp_pack) through their g++
shims, against their plain torch versions and against the JAX package's
device_pipeline functions, on the CPU.

Inputs: the chunk packs of medium at batch 200 (the main layout staged by
the C++ pack_rel, the all-device layout by pack.pack_chunk), branch/search9
(rows the rescue re-runs) and branch/psum0 (the all-dead row); and chunks
made with numpy from a seed that reach m = 0 and m = max_m rows, all-H
rows, rows with >= 70% H, no-H rows with D, symmetric reads (the hdrr
tie), zero counts (an inf or NaN hdrr), counts at and past 32767, and
margins of exactly 0, 1e-30, just below and at 1e-5, inf and NaN.  The
main-layout cases run the DP shim's own two passes, the first with its
prologue, both with their tails; two more numpy chunks reach the tails'
edges (TAIL_CASES): every row rescued, and max_m past the DP kernel's
shared-memory cap (its backpointers in the global scratch on the card).
The all-device cases take the DP shim's passes (fixtures) or numpy
passes.  The EDGES chunks (numpy, in the all-device layout) sit at the edges of the
all-device rel_prep's and rel_settle's launch geometry: tiles of 256
cells that end mid-row and a last tile part full, max_m below and not a
multiple of rel_settle's 128 threads, max_m beyond its 4096-column pair
cache, padding read pairs (the sentinel row Bn and -1), pairs with
m = 0 and pairs whose reconciliation takes the bw row.  Those two
kernels' shims run a block's threads phase by phase, one barrier to the
next.

The JAX side runs as the JAX package's own tests run it, on its CPU
backend: ``_rel_only_core`` (with ``_rel_pipeline`` and ``_pack_out``),
``_unpack`` + ``_un_planes`` + ``_rel_pipeline(demotes=True)`` +
``_reconcile_dev`` and the scatter and flag of ``classify_batch_dev``.
Its DP (``rel_dp_pass2``) is replaced by a stand-in that returns the
same two passes the port's side gets and records the planes and
coverages it is handed (under ``jax.disable_jit``, so the rescue pass's
``lax.cond`` runs eagerly).

Tolerance: bit-equal on every output byte (integers, IEEE f64 compared as
bit patterns, the packed buffer), except a NaN margin, whose four f32
bytes need only be NaN on both sides.  (JAX's ``_reconcile_dev`` divides
as XLA does; on its CPU backend that is IEEE, so it meets the port's
IEEE hdrr on every read here, the exact ties included.)

The ``gpu`` tests run the kernels on the card against their plain
versions and skip without one.  JAX is imported only by the functions
that run it (``_jax``), so that the ``gpu`` tests also run on a machine
that has only the port's dependencies.
"""
import functools
import math
from unittest import mock

import numpy as np
import pytest
import torch

from test_torch_kernel_shim import _load

torch.set_num_threads(1)

REPEAT, HAPLO, DIPLO, N_STATE = 1, 2, 3, 4
# margins at the edges of the risky test and of the f32 conversion
SPECIAL_MM = (0.0, -0.0, 1e-30, math.nextafter(1e-5, 0.0), 1e-5, math.inf,
              math.nan, 5e-6, 0.5, 1e-300, 3.5e38)
FIXTURES = ("medium0", "medium1", "search9", "psum0")
RANDOM = ("rand0", "rand1", "rand2", "rand3")
CASES = FIXTURES + RANDOM
# main-layout chunks at the DP tails' edges: every row's first pass
# rescued; max_m past the 2458 columns whose backpointers fit a block's
# shared memory
TAIL_CASES = ("rescued", "scratch")
# all-device chunks made with numpy at the edges of the all-device prep's
# and rel_settle's launch geometry (tiles of 256 cells, blocks of 128
# threads, a pair cache of 4096 columns): name -> (Bn, max_n, R, max_m,
# the read pairs' m, the pairs' rel_rows: "x" a distinct interval row,
# "pad" the sentinel Bn, "neg" -1)
EDGE_SPECS = {
    # Bn*max_n and R2*max_m not multiples of 256, tiles ending mid-row,
    # max_m below a block's threads
    "ragged": (7, 75, 6, 45, (45, 0, 1, 44, 30, 1),
               ("x", "x", "x", "x", "pad", "neg")),
    # max_m not a multiple of 128: a block's second trip part full
    "wide": (9, 200, 8, 200, (150, 0, 1, 137, 64, 200, 1, 1),
             ("x", "x", "x", "x", "x", "x", "pad", "neg")),
    # max_m beyond the pair cache: columns from 4096 read from global memory
    "tail": (6, 8224, 6, 8224, (8224, 8200, 8193, 5000, 0, 1),
             ("x", "x", "x", "x", "x", "pad")),
}
EDGES = tuple(EDGE_SPECS)


def bits(t):
    """Tensor or array as comparable integers (f64 as bit patterns)."""
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.int64) if a.dtype == np.float64 else a


def assert_bits(got, want):
    g, w = bits(got), bits(want)
    assert g.shape == w.shape
    np.testing.assert_array_equal(g, w)


def assert_packed(got, want, max_m):
    """Every byte equal; a NaN margin's bytes only NaN on both sides."""
    got, want = np.asarray(got), np.asarray(want)
    mm = lambda b: b[:, max_m + 1:].copy().view(np.float32).ravel()
    nan = np.isnan(mm(want))
    np.testing.assert_array_equal(np.isnan(mm(got)), nan)
    np.testing.assert_array_equal(got[~nan], want[~nan])
    np.testing.assert_array_equal(got[nan, :max_m + 1],
                                  want[nan, :max_m + 1])


# ------------------------------------------------------------- inputs

def _jax():
    """jax, jax.numpy and the JAX package's device_pipeline, on JAX's CPU
    backend with 64-bit types."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from classpro_tpu.tpu import device_pipeline

    return jax, jnp, device_pipeline


@functools.lru_cache(maxsize=None)
def _model(fx: str):
    """The port's RelParams of a fixture, on the CPU."""
    from classpro_tpu_torch.params import build_rel_params

    return build_rel_params(_load(fx, 1)[0], "cpu")


@functools.lru_cache(maxsize=None)
def _jax_model(fx: str):
    """The JAX package's RelOnlyParams of a fixture."""
    from test_torch_rel import _jax_gm, _jax_params

    return _jax_params(_jax_gm(fx))


@functools.lru_cache(maxsize=None)
def _staged(fx: str):
    """(main-layout packs, all-device packs) of every chunk of ``fx`` at
    batch 200."""
    from classpro_tpu_torch.engine import TorchEngine
    from classpro_tpu_torch.pack import pack_chunk

    gm, seqs, profs = _load(fx)
    eng = TorchEngine(gm, device="cpu")
    main, alld = [], []
    for lo in range(0, len(seqs), 200):
        pk = eng.stage_pack(seqs[lo:lo + 200], profs[lo:lo + 200])
        if pk is not None:
            main.append(pk)
        st = eng._stage(seqs[lo:lo + 200], profs[lo:lo + 200])
        slab, slot, n_out = st["slab"], st["slot"], st["n_out"]
        rows = [r for r in range(len(st["g"])) if n_out[r] > 0]
        ivs = [slab[r * slot: r * slot + int(n_out[r])]
               for r in range(len(st["g"]))]
        fb, ib, dims, _ = pack_chunk(
            rows, ivs, [len(st["profiles"][i]) for i in st["g"]])
        alld.append((fb, ib, dims))
    return main, alld


def _fixture(case: str):
    fx = {"search9": "branch/search9", "psum0": "branch/psum0"}.get(
        case, "medium")
    k = int(case[-1]) if case.startswith("medium") else 0
    return fx, k


def _dp_passes(planes, cov, P):
    """The DP kernel shim's two passes on the planes (the rescue pass on
    every row, so that both passes are defined everywhere)."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.rel import rescue_rows

    asgn1, _, mm1 = kernels.rel_dp_host(*planes, cov, P)
    _, cov2 = rescue_rows(planes, asgn1, P, asgn1.shape[1])
    asgn2, _, mm2 = kernels.rel_dp_host(*planes, cov2, P)
    return asgn1, mm1, asgn2, mm2


def _row_patterns(rng, m, R, max_m, sym):
    """Two passes of (2R, max_m) int8 assignments: all-H, >= 70% H, no-H
    with D and mixed rows (random values in the padding columns); the
    symmetric reads' bw rows repeat their fw rows in scan order."""
    out = rng.integers(0, 4, (2 * R, max_m)).astype(np.int8)
    for r in range(2 * R):
        n = int(m[r % R])
        kind = rng.integers(0, 5)
        if kind == 0:
            row = np.full(n, HAPLO)
        elif kind == 1:
            row = np.where(rng.random(n) < 0.8, HAPLO,
                           rng.choice([DIPLO, REPEAT], n))
        elif kind == 2:
            row = rng.choice([DIPLO, DIPLO, REPEAT, 0], n)
        elif kind == 3:
            row = np.full(n, REPEAT)
            row[n // 2:] = 0
        else:
            row = rng.integers(0, 4, n)
        out[r, :n] = row
    for j in np.nonzero(sym)[0]:
        out[R + j] = out[j]
    return out


def _margins(rng, n):
    """n DP margins, every value of SPECIAL_MM among them."""
    mm = rng.choice(SPECIAL_MM, n)
    mm[rng.permutation(n)[:len(SPECIAL_MM)]] = SPECIAL_MM
    return mm


def _counts(rng, n, gH, gD, sym):
    """ccb, cce of one read's n intervals: near gH, gD or between,
    constant on a symmetric read, with zeros and counts at and past
    32767."""
    if sym:
        c = np.full(n, int(rng.choice([gH, gD, 7])))
        return c, c.copy()
    centre = int(rng.choice([gH, gD, (gH + gD) // 2, 3 * gH]))
    ccb = np.maximum(rng.integers(centre - 4, centre + 5, n), 0)
    cce = np.maximum(ccb + rng.integers(-3, 4, n), 0)
    special = rng.random(n)
    ccb[special < 0.08] = 0
    cce[(special > 0.92) & (special < 0.95)] = 32767
    ccb[special > 0.97] = 40000
    return ccb, cce


@functools.lru_cache(maxsize=None)
def _main_case(case: str):
    """(fblob, iblob, R, max_m) of a main-layout case: a fixture's chunk,
    or a numpy chunk."""
    if case in FIXTURES:
        fx, k = _fixture(case)
        fb, ib, R, max_m = _staged(fx)[0][k]
        return torch.from_numpy(fb), torch.from_numpy(ib), R, max_m
    P = _P(case)
    gH, gD = int(P.gcov[HAPLO]), int(P.gcov[DIPLO])
    if case in TAIL_CASES:
        # "rescued": counts just below gD and no error evidence, so that
        # every row's first pass is D without H; "scratch": two reads of
        # more than 2458 intervals
        rng = np.random.default_rng(150 + TAIL_CASES.index(case))
        R, max_m = (16, 32) if case == "rescued" else (2, 2500)
        m = (rng.integers(1, max_m + 1, R) if case == "rescued"
             else np.array([max_m, max_m - 37]))
        sym = np.zeros(R, bool)
    else:
        rng = np.random.default_rng(100 + int(case[-1]))
        R, max_m = 16, 32
        m = rng.integers(0, max_m + 1, R)
        m[:3] = [0, max_m, 1]
        sym = rng.random(R) < 0.25
    b = np.zeros((R, max_m), np.int32)
    e = np.ones((R, max_m), np.int32)
    ccb = np.ones((R, max_m), np.int32)
    cce = np.ones((R, max_m), np.int32)
    pe = np.full((R, max_m), -np.inf)
    for j in range(R):
        n = int(m[j])
        starts = np.cumsum(rng.integers(1, 60, n))
        b[j, :n] = starts
        e[j, :n] = starts + rng.integers(1, 50, n)
        if case == "rescued":
            ccb[j, :n] = gD - 2 + rng.integers(-1, 2, n)
            cce[j, :n] = ccb[j, :n] + rng.integers(-1, 2, n)
            continue
        ccb[j, :n], cce[j, :n] = _counts(rng, n, gH, gD, sym[j])
        pe[j, :n] = np.where(rng.random(n) < 0.1, -np.inf,
                             -rng.random(n) * 40)
    plen = rng.integers(100, 5000, R)
    ib = np.concatenate([b.ravel(), e.ravel(), ccb.ravel(), cce.ravel(), m,
                         plen]).astype(np.int32)
    return torch.from_numpy(pe.ravel()), torch.from_numpy(ib), R, max_m


@functools.lru_cache(maxsize=None)
def _fused_main(case: str):
    """The DP shim's two passes on a main-layout case: the first with its
    prologue and tails (rel_dp_first_host), then the rescue pass
    (rel_dp_pack_host) into a copy of its packed buffer.  Returns a dict
    of the planes and coverages the prologue wrote, both passes, rescue,
    cov2 and both packed buffers."""
    from classpro_tpu_torch import kernels

    fb, ib, R, max_m = _main_case(case)
    P = _P(case)
    planes, cov, a1, _, m1, rescue, cov2, packed1 = \
        kernels.rel_dp_first_host(fb, ib, P, R, max_m)
    packed = packed1.clone()
    a2, _, m2 = kernels.rel_dp_pack_host(*planes, cov2, P, rescue, m1,
                                         packed)
    # the rows the rescue pass does not run hold no second pass
    a2 = torch.where(rescue[:, None], a2, a1)
    m2 = torch.where(rescue, m2, m1)
    return {"planes": planes, "cov": cov, "a1": a1, "m1": m1,
            "rescue": rescue, "cov2": cov2, "a2": a2, "m2": m2,
            "packed1": packed1, "packed": packed}


class _StubDP:
    """Stands in for rel_dev2.rel_dp_pass2 in the JAX pipeline: returns
    the given passes in call order and records what it was handed."""

    def __init__(self, passes):
        self.passes = passes
        self.calls = []

    def __call__(self, bpos, bcnt, epos, ecnt, max_cc, lf_bcnt, logpE, m,
                 plen, fwd, cov, P, max_m):
        jnp = _jax()[1]
        self.calls.append({"planes": tuple(np.asarray(x) for x in (
            bpos, bcnt, epos, ecnt, max_cc, lf_bcnt, logpE, m, plen, fwd)),
            "cov": np.asarray(cov)})
        a, mm = self.passes[len(self.calls) - 1]
        return jnp.asarray(a), None, jnp.asarray(mm)


def _stubbed(passes, fn, *args, **kw):
    jax, _, J = _jax()
    stub = _StubDP(passes)
    with mock.patch.object(J, "rel_dp_pass2", stub), jax.disable_jit():
        return fn(*args, **kw), stub


@functools.lru_cache(maxsize=None)
def _jax_main(case: str):
    """JAX's _rel_only_core and _pack_out on a main-layout case, its DP
    returning the DP shim's two passes (_fused_main): (the planes handed
    to its DP, its rescue pass's coverages or None, its (asgn, margin,
    rescue), its packed result)."""
    jax, jnp, J = _jax()
    fb, ib, R, max_m = _main_case(case)
    F = _fused_main(case)
    pp = _jax_model(_fx(case))
    passes = [(F["a1"].numpy(), F["m1"].numpy()),
              (F["a2"].numpy(), F["m2"].numpy())]
    core, stub = _stubbed(passes, J._rel_only_core, jnp.asarray(fb.numpy()),
                          jnp.asarray(ib.numpy()), pp, R, max_m)
    cov2 = stub.calls[1]["cov"] if len(stub.calls) > 1 else None
    with jax.disable_jit():
        packed = np.asarray(J._pack_out(*core, max_m))
    return (stub.calls[0]["planes"], cov2,
            tuple(np.asarray(x) for x in core), packed)


def _fx(case: str) -> str:
    """The fixture whose model a case uses (tiny's for the numpy chunks)."""
    return _fixture(case)[0] if case in FIXTURES else "tiny"


def _P(case: str):
    return _model(_fx(case))


# ------------------------------------------------------ the main layout

@pytest.mark.parametrize("case", CASES + TAIL_CASES)
def test_rel_prep_main(case):
    """The planes, coverages, m, plen and fwd that the first pass's
    prologue writes (rel_dp_first's shim) == rel.prep_ref == the planes
    JAX's _rel_only_core hands its DP, every plane bit for bit (TAIL_CASES:
    every row rescued; max_m past the shared-memory cap)."""
    from classpro_tpu_torch.rel import prep_ref

    fb, ib, R, max_m = _main_case(case)
    P = _P(case)
    F = _fused_main(case)
    planes, cov = F["planes"], F["cov"]
    p_r, c_r = prep_ref(fb, ib, P, R, max_m)
    for a, b in zip(planes + (cov,), p_r + (c_r,)):
        assert a.dtype == b.dtype
        assert_bits(a, b)
    for a, b in zip(planes, _jax_main(case)[0]):
        assert_bits(a, b.astype(bits(a).dtype) if b.dtype == bool else b)
    assert_bits(cov, np.broadcast_to(P.gcov.numpy(), (2 * R, 4)))
    if case in RANDOM:       # m = 0 and m = max_m rows, clamped counts
        m = planes[7].numpy()
        assert (m == 0).any() and (m == max_m).any()
        assert (planes[1].numpy() > 32767).any()


@pytest.mark.parametrize("case", CASES + TAIL_CASES)
def test_rel_rescue(case):
    """The first pass's rescue tail (rel_dp_first's shim): rescue and
    cov2 == rel.rescue_rows on that pass's assignments == JAX's rescue
    flags and rescue-pass coverages; the pass itself bit-equal to the DP
    shim without prologue and tails on rel.prep_ref's planes."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.rel import prep_ref, rescue_rows

    fb, ib, R, max_m = _main_case(case)
    P = _P(case)
    F = _fused_main(case)
    planes, cov = prep_ref(fb, ib, P, R, max_m)
    a, _, mm = kernels.rel_dp_host(*planes, cov, P)
    assert_bits(F["a1"], a)
    assert_bits(F["m1"], mm)
    r_r, c_r = rescue_rows(planes, F["a1"], P, max_m)
    assert_bits(F["rescue"], r_r)
    assert_bits(F["cov2"], c_r)
    _, j_cov2, (_, _, j_res), _ = _jax_main(case)
    assert_bits(F["rescue"], j_res)
    if j_cov2 is not None:
        assert_bits(F["cov2"], j_cov2)
    else:
        assert not bool(F["rescue"].any())
    if case in ("search9",) + RANDOM:
        assert bool(F["rescue"].any())
    if case == "rescued":
        assert bool(F["rescue"].all())
    if case == "scratch":
        assert kernels.rel_dp_geometry(2 * R, max_m, "host")[
            "smem_bytes"] == 0


@pytest.mark.parametrize("case", CASES + TAIL_CASES)
def test_rel_pack(case):
    """The two passes' pack tails (rel_dp_first's shim, then
    rel_dp_pack's): the packed buffer == rel.pack_ref of the two
    passes == JAX's _pack_out of its merged passes, every byte (NaN
    margins: NaN on both sides); the first pass alone writes the rows it
    does not rescue as pack_ref with no row rescued, and a rescue pass
    that runs no row writes nothing."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.rel import pack_ref, prep_ref

    fb, ib, R, max_m = _main_case(case)
    P = _P(case)
    F = _fused_main(case)
    a1, m1, a2, m2, rescue = (F[k] for k in ("a1", "m1", "a2", "m2",
                                             "rescue"))
    got = F["packed"].numpy()
    assert_packed(got, pack_ref(a1, a2, m1, m2, rescue).numpy(), max_m)
    assert_packed(got, _jax_main(case)[3], max_m)
    none = torch.zeros_like(rescue)
    kept = (~rescue).numpy()
    assert_packed(F["packed1"].numpy()[kept],
                  pack_ref(a1, a2, m1, m2, none).numpy()[kept], max_m)
    planes, _ = prep_ref(fb, ib, P, R, max_m)
    again = F["packed"].clone()
    kernels.rel_dp_pack_host(*planes, F["cov2"], P, none, m1, again)
    assert_bits(again, F["packed"])


def _one_state_chunk(R: int = 16, max_m: int = 4):
    """A main-layout numpy chunk whose every row the DP leaves with one
    live state and so an infinite margin: one interval each (m = 1),
    counts of 30000 (H and D dead, R alive) and no error evidence."""
    m = np.ones(R, np.int64)
    b = np.zeros((R, max_m), np.int32)
    e = np.ones((R, max_m), np.int32)
    b[:, 0] = 1 + 7 * np.arange(R)
    e[:, 0] = b[:, 0] + 20
    cc = np.full((R, max_m), 30000, np.int32)
    ib = np.concatenate([b.ravel(), e.ravel(), cc.ravel(), cc.ravel(), m,
                         np.full(R, 1000)]).astype(np.int32)
    fb = np.full(R * max_m, -np.inf)
    return torch.from_numpy(fb), torch.from_numpy(ib), R, max_m


@pytest.mark.parametrize("seed", range(4))
def test_pack_tail_margin_edges(seed):
    """The rescue pass's pack tail on first-pass margins at the f32
    conversion's and the risky test's edges (SPECIAL_MM: 0, -0, 1e-30,
    the double below 1e-5, 1e-5, inf, NaN, 1e-300, 3.5e38, ...; and -inf
    and the smallest double), every row rescued, on a chunk whose own
    margins are all inf (so that the merged margin is the edge value):
    every byte == rel.pack_ref == JAX's _pack_out of the merged margins
    (NaN: NaN on both sides).  JAX is held to it on the rows whose merged
    margin is not subnormal: XLA's CPU backend flushes subnormal doubles
    to zero, so its risky test (v > 0) fails on the smallest double, which
    the card and torch keep."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.rel import pack_ref, prep_ref

    jax, jnp, J = _jax()
    fb, ib, R, max_m = _one_state_chunk()
    P = _P("rand0")
    planes, cov = prep_ref(fb, ib, P, R, max_m)
    rng = np.random.default_rng(400 + seed)
    edges = SPECIAL_MM + (-math.inf, math.ulp(0.0))
    m1 = rng.permutation(np.concatenate([_margins(rng, 2 * R - 2),
                                         edges[-2:]]))
    assert set(m1.view(np.int64)) >= set(np.array(edges).view(np.int64))
    m1 = torch.from_numpy(m1)
    every = torch.ones(2 * R, dtype=torch.bool)
    packed = torch.zeros((2 * R, max_m + 5), dtype=torch.uint8)
    a2, _, m2 = kernels.rel_dp_pack_host(*planes, cov, P, every, m1, packed)
    assert bool(torch.isinf(m2).all())
    got = packed.numpy()
    assert_packed(got, pack_ref(a2, a2, m1, m2, every).numpy(), max_m)
    with jax.disable_jit():
        want = J._pack_out(jnp.asarray(a2.numpy()),
                           jnp.minimum(jnp.asarray(m1.numpy()),
                                       jnp.asarray(m2.numpy())),
                           jnp.asarray(every.numpy()), max_m)
    sub = (m1 != 0) & (m1.abs() < np.finfo(np.float64).tiny)
    assert int(sub.sum()) == 1
    keep = (~sub).numpy()
    assert_packed(got[keep], np.asarray(want)[keep], max_m)


# the margins at the f32 conversion's and the risky test's edges
EDGE_MM = SPECIAL_MM + (-math.inf, math.ulp(0.0), 0.25)


def _edge_pairs():
    """Every (first-pass, rescue-pass) pair of EDGE_MM margins, as two f64
    tensors."""
    mm1 = torch.tensor([a for a in EDGE_MM for _ in EDGE_MM],
                       dtype=torch.float64)
    mm2 = torch.tensor([b for _ in EDGE_MM for b in EDGE_MM],
                       dtype=torch.float64)
    return mm1, mm2


@pytest.mark.parametrize("pass_", ("first", "rescue"))
def test_pack_tail_margin_pairs(pass_):
    """The pack tail's merge and f32 conversion (rel_tail.cuh
    row_tail_byte, through its g++ probe) on every pair of margins at
    the edges (EDGE_MM: 0, -0, NaN, +-inf, the smallest double, 1e-300,
    1e-30, 1e-5 and the double below it, 3.5e38, ...), as the first pass
    writes a row it keeps (its own margin, not rescued) and as the
    rescue pass writes a rescued row (the min of both passes' margins):
    the five bytes == rel.pack_ref's == JAX's _pack_out of the merged
    margin (NaN: NaN on both sides; JAX on the rows whose merged margin
    is not subnormal, which XLA's CPU backend flushes to zero)."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.rel import pack_ref

    jax, jnp, J = _jax()
    mm1, mm2 = _edge_pairs()
    n = mm1.shape[0]
    rescued = torch.full((n,), pass_ == "rescue")
    none = torch.zeros((n, 0), dtype=torch.int8)
    got = (kernels.rel_tail_probe(mm2, mm1) if pass_ == "rescue"
           else kernels.rel_tail_probe(mm1)).numpy()
    want = pack_ref(none, none, mm1, mm2, rescued).numpy()
    assert_packed(got, want, 0)
    merged = np.minimum(mm1.numpy(), mm2.numpy()) if pass_ == "rescue" \
        else mm1.numpy()
    with jax.disable_jit():
        jw = np.asarray(J._pack_out(jnp.asarray(none.numpy()),
                                    jnp.asarray(merged),
                                    jnp.asarray(rescued.numpy()), 0))
    keep = ~((merged != 0) & (np.abs(merged) < np.finfo(np.float64).tiny))
    assert 0 < int(keep.sum()) < n
    assert_packed(got[keep], jw[keep], 0)


def test_rel_tail_probe_checks_inputs():
    """The probe refuses margins of another dtype or length."""
    from classpro_tpu_torch import kernels

    mm = torch.zeros(4, dtype=torch.float64)
    with pytest.raises(ValueError):
        kernels.rel_tail_probe(mm.float())
    with pytest.raises(ValueError):
        kernels.rel_tail_probe(mm, mm[:3])


# -------------------------------------------------- the all-device layout

def _random_alldev(seed: int, P):
    """A numpy chunk of 12 reads through pack.pack_chunk: interval records
    with random reliable flags (one read with exactly 32 reliable
    intervals, so m = max_m), counts as _counts makes them."""
    from classpro_tpu_torch.native import _IVDT
    from classpro_tpu_torch.pack import pack_chunk

    rng = np.random.default_rng(200 + seed)
    gH, gD = int(P.gcov[HAPLO]), int(P.gcov[DIPLO])
    ivs, sym = [], []
    for r in range(12):
        n = 40 if r == 0 else int(rng.integers(1, 40))
        rec = np.zeros(n, _IVDT)
        starts = np.cumsum(rng.integers(1, 60, n))
        rec["b"], rec["e"] = starts, starts + rng.integers(1, 50, n)
        s = bool(rng.random() < 0.25)
        rec["ccb"], rec["cce"] = _counts(rng, n, gH, gD, s)
        rec["cb"] = np.maximum(rec["ccb"] + rng.integers(-2, 3, n), 0)
        rec["ce"] = np.maximum(rec["cce"] + rng.integers(-2, 3, n), 0)
        rel = rng.random(n) < rng.choice([0.3, 0.7, 1.0])
        if r == 0:
            rel[:] = False
            rel[:32] = True
        rec["is_rel"] = rel
        for k in ("pe", "pe_o_b", "pe_o_e"):
            rec[k] = -rng.random(n) * 40
        ivs.append(rec)
        sym.append(s)
    plens = [int(x) for x in rng.integers(2000, 9000, 12)]
    fb, ib, dims, meta = pack_chunk(list(range(12)), ivs, plens)
    return fb, ib, dims, rng


def _edge_alldev(case: str, P):
    """An all-device chunk of EDGE_SPECS[case] in the blob layout of
    alldev.py, made with numpy from a seed: interval rows of random
    length, read pairs with the given m and rel_rows (distinct interval
    rows, the sentinel Bn or -1), the bw rows the fw rows reversed within
    m and distinct increasing rel_cols within m, as pack.pack_chunk lays
    them out; past m the sentinel max_n on odd pairs, and on even pairs
    more distinct columns (the scatter writes padding columns too)."""
    from classpro_tpu_torch.numerics import LOGFACT

    Bn, max_n, R, max_m, m, kinds = EDGE_SPECS[case]
    rng = np.random.default_rng(300 + EDGES.index(case))
    gH, gD = int(P.gcov[HAPLO]), int(P.gcov[DIPLO])
    lf = lambda c: LOGFACT[np.minimum(c, 32767)]

    def planes(rows, cols):
        b = np.cumsum(rng.integers(1, 60, (rows, cols)), axis=1)
        e = b + rng.integers(1, 50, (rows, cols))
        cnt = [_counts(rng, cols, gH, gD, rng.random() < 0.25)
               for _ in range(rows)]
        ccb = np.stack([c[0] for c in cnt])
        cce = np.stack([c[1] for c in cnt])
        pe = np.where(rng.random((rows, cols)) < 0.1, -np.inf,
                      -rng.random((rows, cols)) * 40)
        return b, e, ccb, cce, pe

    b, e, cb, ce, pe = planes(Bn, max_n)
    ccb = np.maximum(cb + rng.integers(-2, 3, cb.shape), 0)
    cce = np.maximum(ce + rng.integers(-2, 3, ce.shape), 0)
    n = rng.integers(1, max_n + 1, Bn)
    live = np.arange(max_n)[None, :] < n[:, None]
    idx = [rng.integers(0, max_n, (Bn, max_n)) for _ in range(2)]
    is_rel = rng.integers(0, 2, (Bn, max_n))
    pe2 = [-rng.random((Bn, max_n)) * 40 for _ in range(2)]

    m = np.array(m)
    rb, re, rcb, rce, rpe = planes(R, max_m)
    cols = np.arange(max_m)
    flip = np.where(cols[None, :] < m[:, None], m[:, None] - 1 - cols,
                    cols)
    rev = lambda a: np.take_along_axis(a, flip, axis=1)
    mcc = np.maximum(rcb, rce)
    real = rng.permutation(Bn)
    rel_rows = np.array([{"pad": Bn, "neg": -1}.get(k, 0) for k in kinds])
    rel_rows[[k == "x" for k in kinds]] = real[:kinds.count("x")]
    rel_cols = np.full((R, max_m), max_n)
    for j in range(R):
        if kinds[j] == "x":
            w = max_m if j % 2 == 0 else m[j]
            rel_cols[j, :w] = np.sort(rng.choice(max_n, w, False))
    ib = np.concatenate([x.ravel() for x in (
        b, e, cb, ce, ccb, cce, idx[0], idx[1], is_rel, live, n,
        np.concatenate([rb, rev(re) - 1]), np.concatenate([rcb, rev(rce)]),
        np.concatenate([re - 1, rev(rb)]), np.concatenate([rce, rev(rcb)]),
        np.concatenate([mcc, rev(mcc)]), rel_cols, np.concatenate([m, m]),
        np.tile(rng.integers(100, 9000, R), 2),
        np.repeat([1, 0], R), rel_rows)]).astype(np.int32)
    fb = np.concatenate([x.ravel() for x in (
        pe, pe2[0], pe2[1], lf(cb), lf(ce),
        np.concatenate([rpe, rev(rpe)]),
        np.concatenate([lf(rcb), rev(lf(rce))]),
        np.concatenate([lf(rce), rev(lf(rcb))]))]).astype(np.float64)
    return fb, ib, (Bn, max_n, 2 * R, max_m), rng


@functools.lru_cache(maxsize=None)
def _alldev_case(case: str):
    """(fblob, iblob, dims, asgn1, mm1, asgn2, mm2) of an all-device
    case."""
    from classpro_tpu_torch.alldev import prep_ref

    P = _P(case)
    if case in FIXTURES:
        fx, k = _fixture(case)
        fb, ib, dims = _staged(fx)[1][k]
    elif case in EDGES:
        fb, ib, dims, rng = _edge_alldev(case, P)
    else:
        fb, ib, dims, rng = _random_alldev(int(case[-1]), P)
    Bn, max_n, R2, max_m = dims
    fb, ib = torch.from_numpy(fb), torch.from_numpy(ib)
    planes, cov, _ = prep_ref(fb, ib, P, R2 // 2, max_m, Bn, max_n)
    if case in FIXTURES:
        return (fb, ib, dims) + _dp_passes(planes, cov, P)
    m = planes[7].numpy()[:R2 // 2]
    sym = np.zeros(R2 // 2, bool)
    sym[::3] = True
    t = torch.from_numpy
    out = [fb, ib, dims]
    for _ in range(2):
        a = _row_patterns(rng, m, R2 // 2, max_m, sym)
        if case in EDGES:
            _suffix_pair(a, int(m[0]), R2 // 2)
        out += [t(a), t(_margins(rng, R2))]
    return tuple(out)


def _suffix_pair(a, m: int, R: int) -> None:
    """Read pair 0 of passes ``a`` (2R, max_m) with m >= 4 columns: fw row
    0, 0, H, D, H, D, ..., R (no rescue, no demotion; its reversal opens
    with R and is zero after its first zero: is_eq_suffix), bw row all R,
    so that the reconciliation takes the bw row; past m the bw row's
    padding differs from the fw row's (both are scattered where rel_cols
    is valid there)."""
    row = np.where(np.arange(m) % 2, DIPLO, HAPLO)
    row[:2] = 0
    row[-1] = REPEAT
    a[0, :m] = row
    a[R, :m] = REPEAT
    a[R, m:] = (a[0, m:] + 1) % 4


@functools.lru_cache(maxsize=None)
def _jax_alldev(case: str):
    """JAX's side of an all-device case: the DP planes its _rel_pipeline
    hands the DP, _un_planes, the demoted rows, _reconcile_dev, and the
    scatter and rel flag of classify_batch_dev."""
    jax, jnp, J = _jax()
    fb, ib, dims, a1, m1, a2, m2 = _alldev_case(case)
    Bn, max_n, R2, max_m = dims
    R = R2 // 2
    pp = _jax_model(_fx(case))
    EPS = 1e-5
    # JAX's scatters wrap a negative row index; the port drops it, as it
    # drops the sentinel Bn, so JAX gets Bn there
    ib = ib.numpy().copy()
    rows = ib[len(ib) - R:]
    rows[rows < 0] = Bn
    with jax.disable_jit():
        U = J._unpack(jnp.asarray(fb.numpy()), jnp.asarray(ib), *dims)
        P13, packL, packR = J._un_planes(U, pp)
        (rel2, mm, rescue), stub = _stubbed(
            [(a1.numpy(), m1.numpy()), (a2.numpy(), m2.numpy())],
            J._rel_pipeline, U, pp, R2, max_m)
        rel_out = J._reconcile_dev(rel2, U["m"], U["bcnt"], U["ecnt"],
                                 U["fwd"], R, max_m)
        asgn = jnp.full((Bn, max_n), N_STATE, jnp.int32).at[
            U["rel_rows"][:, None], U["rel_cols"]].set(rel_out, mode="drop")
        risky = lambda v: (v > 0.0) & (v < EPS)
        flag = jnp.zeros(Bn, jnp.int32).at[U["rel_rows"]].max(
            (risky(mm[:R]) | risky(mm[R:])).astype(jnp.int32), mode="drop")
    return {"planes": stub.calls[0]["planes"], "cov": stub.calls[0]["cov"],
            "P13": np.asarray(P13), "packL": np.asarray(packL),
            "packR": np.asarray(packR), "is_rel": np.asarray(U["is_rel"]),
            "live": np.asarray(U["live"]), "rel2": np.asarray(rel2),
            "rel_out": np.asarray(rel_out), "asgn": np.asarray(asgn),
            "flag": np.asarray(flag) > 0}


@pytest.mark.parametrize("case", CASES + EDGES)
def test_rel_prep_alldev(case):
    """rel_prep's shim in the all-device layout == alldev.prep_ref == the
    planes JAX's _rel_pipeline hands its DP and its _un_planes, bit for
    bit; the sweeps' assignment rows all N_STATE, every gate unflagged."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.alldev import prep_ref
    from classpro_tpu_torch.kernels import GATE_UNFLAGGED

    fb, ib, dims = _alldev_case(case)[:3]
    Bn, max_n, R2, max_m = dims
    P = _P(case)
    planes, cov, un = kernels.rel_prep_host(fb, ib, P, R2 // 2, max_m,
                                            (Bn, max_n))
    p_r, c_r, un_r = prep_ref(fb, ib, P, R2 // 2, max_m, Bn, max_n)
    for a, b in zip(planes + (cov,), p_r + (c_r,)):
        assert a.dtype == b.dtype
        assert_bits(a, b)
    assert set(un) == set(un_r)
    for k in un:
        assert un[k].dtype == un_r[k].dtype
        assert_bits(un[k], un_r[k])
    J = _jax_alldev(case)
    for a, b in zip(planes, J["planes"]):
        assert_bits(a, b.astype(bits(a).dtype) if b.dtype == bool else b)
    assert_bits(cov, J["cov"])
    for k in ("P13", "packL", "packR"):
        assert_bits(un[k], J[k])
    assert_bits(un["is_rel"], J["is_rel"] != 0)
    assert_bits(un["live"], J["live"] != 0)
    assert bool((un["asgn"] == N_STATE).all())
    assert_bits(un["gate"], np.array(GATE_UNFLAGGED)[:, None].repeat(Bn, 1))


@pytest.mark.parametrize("case", CASES + EDGES)
def test_rel_settle(case):
    """rel_settle's shim == alldev.settle_ref (sweep assignments and
    margin gate, bit for bit) == JAX's _demotes_dev + _reconcile_dev +
    scatter and its rel flag (the gate's lower bound -inf exactly where
    the flag is set)."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.alldev import prep_ref, settle_ref
    from classpro_tpu_torch.kernels import blob_views
    from classpro_tpu_torch.rel import rescue_rows

    fb, ib, dims, a1, m1, a2, m2 = _alldev_case(case)
    Bn, max_n, R2, max_m = dims
    R = R2 // 2
    P = _P(case)
    planes, _, un = prep_ref(fb, ib, P, R, max_m, Bn, max_n)
    rescue, _ = rescue_rows(planes, a1, P, max_m)
    V = blob_views(fb, ib, *dims)
    args = (a1, a2, m1, m2, rescue, planes, V["rel_rows"], V["rel_cols"], P)
    got = (un["asgn"].clone(), un["gate"].clone())
    want = (un["asgn"].clone(), un["gate"].clone())
    kernels.rel_settle_host(*args, *got)
    settle_ref(*args, *want)
    assert_bits(got[0], want[0])
    assert_bits(got[1], want[1])

    J = _jax_alldev(case)
    np.testing.assert_array_equal(got[0].numpy(), J["asgn"])
    flag = got[1][0].numpy() == -np.inf
    np.testing.assert_array_equal(flag, J["flag"])
    np.testing.assert_array_equal(flag, got[1][1].numpy() == np.inf)


def test_random_cases_reach_the_branches():
    """The numpy chunks reach what they were made for: bw rows taken by
    the reconciliation, symmetric reads whose fw row is not the reversed
    bw row (the hdrr tie), zero counts at D or H intervals (an inf or NaN
    hdrr), reads with and without a risky rel margin, m = max_m rows."""
    from classpro_tpu_torch.kernels import blob_views

    took = tie = zero = flagged = unflagged = full = 0
    for case in RANDOM:
        fb, ib, dims = _alldev_case(case)[:3]
        Bn, max_n, R2, max_m = dims
        R = R2 // 2
        J = _jax_alldev(case)
        rel2, out = J["rel2"], J["rel_out"]
        m = J["planes"][7][:R]
        inb = np.arange(max_m)[None, :] < m[:, None]
        live = blob_views(fb, ib, *dims)["rel_rows"].numpy() < Bn
        took += int((((out != rel2[:R]) & inb).any(1) & live).sum())
        flip = np.where(inb, m[:, None] - 1 - np.arange(max_m)[None, :],
                        np.arange(max_m)[None, :])
        bw = np.take_along_axis(rel2[R:], flip, axis=1)
        bc, ec = J["planes"][1][:R], J["planes"][3][:R]
        sym = (bc == np.take_along_axis(ec, flip, axis=1)) | ~inb
        tie += int((sym.all(1) & ((rel2[:R] != bw) & inb).any(1)
                    & live).sum())
        dh = inb & ((rel2[:R] == DIPLO) | (rel2[:R] == HAPLO))
        zero += int((dh & (bc == 0)).any(1).sum())
        flagged += int(J["flag"].sum())
        unflagged += int((~J["flag"]).sum())
        full += int((m == max_m).sum())
    assert took and tie and zero and flagged and unflagged and full


@pytest.mark.parametrize("case", EDGES)
def test_edge_cases_reach_their_edges(case):
    """Each edge chunk has what it was made for: the geometry of its
    spec, padding pairs (dropped: their interval rows keep N_STATE), a
    live pair with m = 0, and live pairs whose reconciliation takes the
    bw row (in "tail", one with columns past the pair cache; in "wide",
    one that also scatters padding columns)."""
    from classpro_tpu_torch import kernels

    TILE, THREADS, CACHE = 256, 128, 4096
    Bn, max_n, R, max_m, m, kinds = EDGE_SPECS[case]
    dims = _alldev_case(case)[2]
    assert dims == (Bn, max_n, 2 * R, max_m)
    cells = (2 * R * max_m, Bn * max_n)
    geo = kernels.glue_geometry("rel_settle", R, "host", n2=max_m)
    cache = (geo["smem_bytes"] - 560) // 7
    if case == "ragged":
        assert all(c % TILE and TILE % w for c, w in zip(cells, (max_m,
                                                                max_n)))
        assert max_m < THREADS
    if case == "wide":
        assert THREADS < max_m and max_m % THREADS
    if case == "tail":
        assert cache == CACHE < max_m
    else:
        assert cache == max_m

    J = _jax_alldev(case)
    rel2, out = J["rel2"], J["rel_out"]
    mm = np.array(m)
    live = np.array([k == "x" for k in kinds])
    assert (~live).any() and (live & (mm == 0)).any()
    inb = np.arange(max_m)[None, :] < mm[:, None]
    took = ((out != rel2[:R]) & inb).any(1) & live
    assert took.any()
    if case == "tail":
        assert (took & (mm > CACHE)).any()
    if case == "wide":
        assert took[0] and mm[0] < max_m


# ------------------------------------------------- wrappers, geometry, gpu

def test_glue_wrappers_check_inputs_and_run_plain_on_cpu():
    """Wrong dtypes, shapes or blob lengths raise; on CPU tensors the
    wrappers run the plain versions and count no launch (rel_dp_first's
    plain version packs every row; its rescued rows are rel_dp_pack's)."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.rel import pack_ref, prep_ref

    fb, ib, R, max_m = _main_case("rand0")
    P = _P("rand0")
    F = _fused_main("rand0")
    with pytest.raises(ValueError, match="iblob"):
        kernels.rel_dp_first_host(fb, ib[:-1], P, R, max_m)
    with pytest.raises(ValueError, match="fblob"):
        kernels.rel_dp_first_host(fb.to(torch.float32), ib, P, R, max_m)
    planes, cov = prep_ref(fb, ib, P, R, max_m)
    with pytest.raises(ValueError, match="cov"):
        kernels.rel_dp_rescue_host(*planes, cov[:, :3].contiguous(), P)
    with pytest.raises(ValueError, match="mm1"):
        kernels.rel_dp_pack_host(*planes, F["cov2"], P, F["rescue"],
                                 F["m1"][:-1], F["packed"].clone())
    with pytest.raises(ValueError, match="packed"):
        kernels.rel_dp_pack_host(*planes, F["cov2"], P, F["rescue"],
                                 F["m1"], F["packed"][:, :-1].clone())
    with pytest.raises(ValueError, match="active"):
        kernels.rel_dp_pack_host(*planes, F["cov2"], P,
                                 F["rescue"].to(torch.uint8), F["m1"],
                                 F["packed"].clone())
    n0 = dict(kernels.LAUNCHES)
    p_k, c_k, a1, _, m1, rescue, cov2, packed = kernels.rel_dp_first(
        fb, ib, P, R, max_m)
    for a, b in zip(p_k + (c_k, a1, m1, rescue, cov2),
                    planes + (cov, F["a1"], F["m1"], F["rescue"],
                              F["cov2"])):
        assert_bits(a, b)
    assert_packed(packed.numpy(), pack_ref(a1, a1, m1, m1,
                                           torch.zeros_like(rescue)).numpy(),
                  max_m)
    a2, _, m2 = kernels.rel_dp_pack(*planes, cov2, P, rescue, m1, packed)
    assert_packed(packed.numpy(), F["packed"].numpy(), max_m)
    for a, b in zip(kernels.rel_dp_rescue(*planes, cov, P),
                    (a1, None, m1, rescue, cov2)):
        if b is not None:
            assert_bits(a, b)
    assert kernels.LAUNCHES == n0


def test_glue_geometry():
    """rel_prep (all-device layout): a block of 256 per tile of 256
    rel-plane cells, then per tile of interval cells, its records staged
    in 38,944 bytes of shared memory; rel_settle: a block of 128 per read
    pair, 560 bytes of the warps' partials and a pair cache of 7 x
    min(max_m, 4096) bytes (int32 rel_cols, both rows' int8 states, the
    scatter's candidates)."""
    from classpro_tpu_torch import kernels

    assert kernels.glue_geometry("rel_prep", 512 * 128, "host",
                                 n2=256 * 192 + 1) == {
        "threads_per_block": 256, "blocks": 256 + 193, "smem_bytes": 38944}
    assert kernels.glue_geometry("rel_prep", 512 * 128 + 1, "host",
                                 n2=0)["blocks"] == 257
    for max_m, cache in ((128, 7 * 128), (8224, 7 * 4096)):
        assert kernels.glue_geometry("rel_settle", 511, "host",
                                     n2=max_m) == {
            "threads_per_block": 128, "blocks": 511,
            "smem_bytes": 560 + cache}


def _card_params(case):
    from classpro_tpu_torch.params import build_rel_params

    return build_rel_params(_load(_fx(case), 1)[0], "cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ("medium0", "search9", "rand0", "rand1")
                         + TAIL_CASES)
def test_main_glue_kernels_match_plain_on_card(case):
    """The DP kernel's two launches of the main path (rel_dp_first: the
    prologue and both tails; rel_dp_pack) on the card against their plain
    versions on the same card inputs, bit for bit: the planes and
    coverages the prologue writes (rel.prep_ref), the first pass against
    rel_dp's on those planes, its rescue and cov2 on its own assignments
    (rel.rescue_rows), the packed buffer on its own two passes
    (rel.pack_ref), and the rescue pass's pack tail on margins at the f32
    conversion's edges; each launch counted, no rel_prep launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.rel import pack_ref, prep_ref, rescue_rows

    fb, ib, R, max_m = (t.cuda() if isinstance(t, torch.Tensor) else t
                        for t in _main_case(case))
    P = _card_params(case)
    n0 = dict(kernels.LAUNCHES)
    planes, cov, a1, d1, m1, rescue, cov2, packed = kernels.rel_dp_first(
        fb, ib, P, R, max_m)
    p_r, c_r = prep_ref(fb, ib, P, R, max_m)
    b1, e1, n1 = kernels.rel_dp(*p_r, c_r, P)
    r_r, c2_r = rescue_rows(planes, a1, P, max_m)
    a2, _, m2 = kernels.rel_dp_pack(*planes, cov2, P, rescue, m1, packed)
    want = pack_ref(a1, a2, m1, m2, rescue)
    # the f32 edges through the rescue pass's pack tail, on a chunk whose
    # own margins are all inf
    efb, eib, eR, eM = (t.cuda() if isinstance(t, torch.Tensor) else t
                        for t in _one_state_chunk())
    EP = _card_params("rand0")
    e_planes, e_cov = kernels.rel_dp_first(efb, eib, EP, eR, eM)[:2]
    every = torch.ones(2 * eR, dtype=torch.bool, device="cuda")
    edges = torch.from_numpy(np.concatenate([
        _margins(np.random.default_rng(5), 2 * eR - 2),
        [-math.inf, math.ulp(0.0)]])).cuda()
    e_packed = torch.zeros((2 * eR, eM + 5), dtype=torch.uint8,
                           device="cuda")
    e_a2, _, e_m2 = kernels.rel_dp_pack(*e_planes, e_cov, EP, every, edges,
                                        e_packed)
    e_want = pack_ref(e_a2, e_a2, edges, e_m2, every)
    torch.cuda.synchronize()
    for a, b in zip(planes + (cov, a1, d1, m1, rescue, cov2),
                    p_r + (c_r, b1, e1, n1, r_r, c2_r)):
        assert_bits(a.cpu(), b.cpu())
    assert_packed(packed.cpu().numpy(), want.cpu().numpy(), max_m)
    assert bool(torch.isinf(e_m2).all())
    assert_packed(e_packed.cpu().numpy(), e_want.cpu().numpy(), eM)
    assert kernels.LAUNCHES["rel_prep"] == n0["rel_prep"]
    assert kernels.LAUNCHES["rel_dp"] == n0["rel_dp"] + 5
    if case == "rescued":
        assert bool(rescue.all())
    if case == "scratch":
        assert kernels.rel_dp_geometry(2 * R, max_m)["smem_bytes"] == 0


@pytest.mark.gpu
@pytest.mark.parametrize("pass_", ("first", "rescue"))
def test_pack_tail_margin_pairs_on_card(pass_):
    """The pack tail's merge and f32 conversion on the card (the probe
    built with the DP kernel) on every pair of EDGE_MM margins against
    rel.pack_ref on the card, every byte (the card's zero of min(+0, -0)
    is torch's CUDA one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.rel import pack_ref

    mm1, mm2 = (t.cuda() for t in _edge_pairs())
    n = mm1.shape[0]
    rescued = torch.full((n,), pass_ == "rescue", device="cuda")
    none = torch.zeros((n, 0), dtype=torch.int8, device="cuda")
    got = (kernels.rel_tail_probe(mm2, mm1) if pass_ == "rescue"
           else kernels.rel_tail_probe(mm1))
    want = pack_ref(none, none, mm1, mm2, rescued)
    assert_packed(got.cpu().numpy(), want.cpu().numpy(), 0)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ("medium0", "psum0", "rand0", "rand1")
                         + EDGES)
def test_alldev_glue_kernels_match_plain_on_card(case):
    """rel_prep (all-device layout), the DP's first pass with its rescue
    tail (rel_dp_rescue) and rel_settle on the card against their plain
    versions on the same card inputs, bit for bit (the EDGES chunks:
    ragged tiles, a block's part-full trip, the pair cache's global tail,
    padding pairs, m = 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.alldev import prep_ref, settle_ref
    from classpro_tpu_torch.kernels import blob_views
    from classpro_tpu_torch.rel import rescue_rows

    fb, ib, dims, a1, m1, a2, m2 = (
        t.cuda() if isinstance(t, torch.Tensor) else t
        for t in _alldev_case(case))
    Bn, max_n, R2, max_m = dims
    P = _card_params(case)
    planes, cov, un = kernels.rel_prep(fb, ib, P, R2 // 2, max_m,
                                       (Bn, max_n))
    p_r, c_r, un_r = prep_ref(fb, ib, P, R2 // 2, max_m, Bn, max_n)
    for a, b in zip(planes + (cov,), p_r + (c_r,)):
        assert_bits(a.cpu(), b.cpu())
    for k in un:
        assert_bits(un[k].cpu(), un_r[k].cpu())
    k_a1, _, _, k_res, k_cov2 = kernels.rel_dp_rescue(*planes, cov, P)
    for a, b in zip((k_res, k_cov2), rescue_rows(planes, k_a1, P, max_m)):
        assert_bits(a.cpu(), b.cpu())
    rescue, _ = rescue_rows(planes, a1, P, max_m)
    V = blob_views(fb, ib, *dims)
    args = (a1, a2, m1, m2, rescue, planes, V["rel_rows"], V["rel_cols"], P)
    got = (un["asgn"].clone(), un["gate"].clone())
    want = (un["asgn"].clone(), un["gate"].clone())
    kernels.rel_settle(*args, *got)
    settle_ref(*args, *want)
    torch.cuda.synchronize()
    assert_bits(got[0].cpu(), want[0].cpu())
    assert_bits(got[1].cpu(), want[1].cpu())
