"""The all-device classification of one chunk (``classify_batch``).

The counterpart of the JAX package's ``device_pipeline.classify_batch_dev``
(device_pipeline.py:672-705) and its helpers: the DP with the no-H rescue
(K1-K4, the kernel csrc/rel_dp.cu), the post-rescue demotions, the fw/bw
reconciliation and the relaxation planes (K6, torch ops once per chunk),
then both relaxation sweeps (K5, the kernel csrc/unrel.cu).
``parallel.mesh.sharded_classify`` runs it once per read shard, each on
its own device.

Blob layouts (pack.pack_chunk builds them):

  iblob (int32): b,e,cb,ce,ccb,cce,idx_desc,idx_asc,is_rel,live
                 [10 x Bn*max_n] | n [Bn] |
                 bpos,bcnt,epos,ecnt,max_cc [5 x R2*max_m] |
                 rel_cols [R*max_m] | m,plen,fwd [3 x R2] | rel_rows [R]
  fblob (f64):   pe,peob,peoe,lf_cb,lf_ce [5 x Bn*max_n] |
                 pe_rel,lf_bcnt,lf_ecnt [3 x R2*max_m]

Where the JAX code mixes int64 with a Python float the port casts to
float64 first (torch would give float32); the reconciliation's hdrr
divides in IEEE float64, so it equals the host ``rel.reconcile_fwbw`` on
every row; the ``mode="drop"`` scatters send their sentinel indices to a
spare row or column that is then cut off.

On a card (``impl="cuda"``) a chunk is five launches (``classify_glued``):
the glue kernels of csrc/glue.cu (rel_prep in this layout, rel_settle)
around the DP kernel's two passes (the first with its rescue tail) and
the sweep kernel with its gate tail, which writes the packed result
(each read's assignment bytes, then its guard flag).  The five are
captured once per (device, Bn, max_n, R2, max_m) bucket and model in a
CUDA graph (``BatchGraph``, cached by ``BatchGraphs``), which each chunk
replays, as the JAX package runs one jitted program per bucket.  The
torch functions here are their plain versions (``prep_ref``,
``settle_ref`` built from ``dp_planes``, ``un_planes``, ``demotes_dev``,
``reconcile_dev`` and ``sweep_inputs``' scatter, ``gate_ref``).
"""

from __future__ import annotations

import math

import torch

from classpro_tpu_torch.kernels import GATE_UNFLAGGED, blob_views
from classpro_tpu_torch.params import PipelineParams, RelParams
from classpro_tpu_torch.rel import (REL_MARGIN_EPS, BlobGraph, GraphCache,
                                    default_impl, e_emission, merge_passes,
                                    rel_pipeline as _rel_dp)

ERROR, REPEAT, HAPLO, DIPLO, N_STATE = 0, 1, 2, 3, 4

_RE_PLANES = ("bpos", "bcnt", "epos", "ecnt", "max_cc")

def unpack(fblob: torch.Tensor, iblob: torch.Tensor, Bn: int, max_n: int,
           R2: int, max_m: int) -> dict:
    """Views of the two blobs (device_pipeline._unpack); the rel planes
    and m, plen as int64, fwd as bool."""
    U = blob_views(fblob, iblob, Bn, max_n, R2, max_m)
    for k in _RE_PLANES + ("m", "plen"):
        U[k] = U[k].to(torch.int64)
    U["fwd"] = U["fwd"] != 0
    return U


def demotes_dev(asgn, rescue, inb, l_arr, bcnt, ecnt, m, gHi, gDi):
    """Post-rescue demotions (class_rel.c:650-713) on the device
    (device_pipeline._demotes_dev), exact int64: ``asgn`` int64 (R2, M)
    scan-order rows, ``rescue`` bool (R2,), ``inb`` bool (R2, M),
    ``l_arr``/``bcnt``/``ecnt`` int64 (R2, M), ``m`` int64 (R2,), ``gHi``/
    ``gDi`` int64 scalars or (R2,).  Returns the demoted int64 rows."""
    zero = torch.zeros_like(l_arr)
    half = torch.div((bcnt + ecnt) * l_arr, 2, rounding_mode="floor")

    def dsum(a, state):
        mask = inb & (a == state)
        return (torch.where(mask, l_arr, zero).sum(1),
                torch.where(mask, half, zero).sum(1))

    def nearer_d(csum, lsum):      # |csum - gH*lsum| >= |csum - gD*lsum|
        return (csum - gHi * lsum).abs() >= (csum - gDi * lsum).abs()

    # second no-h check -> demote D to H (class_rel.c:650-669); lsum2 == 0
    # is C's 0.0/0 mean, NaN, whose fabs compare is false
    no_h2 = rescue & ~(inb & (asgn == HAPLO)).any(1)
    lsum2, csum2 = dsum(asgn, DIPLO)
    flip = no_h2 & (lsum2 > 0) & ((csum2 - gHi * lsum2).abs()
                                  <= (csum2 - gDi * lsum2).abs())
    asgn = torch.where(flip[:, None] & (asgn == DIPLO), HAPLO, asgn)

    # all-H -> maybe all-D (class_rel.c:674-690)
    all_h = (~inb | (asgn == HAPLO)).all(1)
    lsum_a = torch.where(inb, l_arr, zero).sum(1)
    csum_a = torch.where(inb, half, zero).sum(1)
    flip_all = all_h & nearer_d(csum_a, lsum_a)
    asgn = torch.where(flip_all[:, None] & inb,
                       torch.where(asgn == HAPLO, DIPLO, asgn), asgn)

    # >= 70% H -> demote H->D, D->R (class_rel.c:692-713); the 0.7
    # product in float64, as JAX computes it
    n_h = (inb & (asgn == HAPLO)).sum(1)
    many_h = n_h.to(torch.float64) >= m.to(torch.float64) * 0.7
    lsum_h, csum_h = dsum(asgn, HAPLO)
    demote = many_h & (lsum_h > 0) & nearer_d(csum_h, lsum_h)
    dm = demote[:, None] & inb
    return torch.where(dm & (asgn == HAPLO), DIPLO,
                       torch.where(dm & (asgn == DIPLO), REPEAT, asgn))


def demote_rows(U: dict, asgn8, rescue, P: RelParams):
    """demotes_dev on a chunk's post-rescue DP rows (int8 (R2, max_m))."""
    cols = torch.arange(asgn8.shape[1], device=asgn8.device)[None, :]
    inb = cols < U["m"][:, None]
    l_arr = torch.abs(U["epos"] - U["bpos"]) + 1
    return demotes_dev(asgn8.to(torch.int64), rescue, inb, l_arr, U["bcnt"],
                       U["ecnt"], U["m"], P.gcov[HAPLO], P.gcov[DIPLO])


def dp_planes(U: dict, P: RelParams) -> tuple:
    """The DP's plane tuple (kernels.rel_dp's arguments) of an unpacked
    chunk, with its E emission."""
    logpE = e_emission(U["bcnt"], U["ecnt"], U["lf_bcnt"], U["lf_ecnt"],
                       U["pe_rel"], P)
    return tuple(U[k] for k in _RE_PLANES) + (
        U["lf_bcnt"].contiguous(), logpE, U["m"], U["plen"], U["fwd"])


def rel_pipeline(U: dict, P: RelParams, max_m: int, impl):
    """DP + no-H rescue pass (rel.rel_pipeline) + the demotions
    (device_pipeline._rel_pipeline with demotes=True): returns (asgn int64
    (R2, max_m) scan-order rows, margin f64 (R2,), rescue bool (R2,))."""
    asgn8, mm, rescue = _rel_dp(dp_planes(U, P), P, max_m, impl)
    return demote_rows(U, asgn8, rescue, P), mm, rescue


def _first_true(mask):
    """(first True column, any) per row: jnp.argmax's first-wins index,
    0 where the row has none."""
    M = mask.shape[1]
    cols = torch.arange(M, device=mask.device)[None, :]
    first = torch.where(mask, cols, M).amin(1)
    anyv = first < M
    return torch.where(anyv, first, 0), anyv


def _at(a, idx):
    return torch.gather(a, 1, idx[:, None])[:, 0]


def reconcile_dev(asgn, m, bcnt, ecnt, fwd, R: int, max_m: int):
    """fw/bw reconciliation (class_rel.c:847-938) on the device
    (device_pipeline._reconcile_dev): ``asgn`` (2R, max_m) scan-order rows
    (fw rows, then bw rows), ``m`` int64 (2R,), ``bcnt``/``ecnt`` int64
    (2R, max_m), ``fwd`` bool (2R,).  Returns the (R, max_m) forward-order
    assignment.  hdrr divides in IEEE float64 and a NaN hdrr takes the bw
    row, as the host reconcile_fwbw does."""
    cols = torch.arange(max_m, device=asgn.device)[None, :]
    inb = cols < m[:, None]
    dm = inb & (asgn == DIPLO)
    hm = inb & (asgn == HAPLO)
    f_d, any_d = _first_true(dm)
    f_h, any_h = _first_true(hm)
    l_d = max_m - 1 - _first_true(dm.flip(1))[0]
    l_h = max_m - 1 - _first_true(hm.flip(1))[0]
    f64 = torch.float64
    p = _at(bcnt, f_d).to(f64) / _at(bcnt, f_h).to(f64)
    q = _at(ecnt, l_d).to(f64) / _at(ecnt, l_h).to(f64)
    hdrr = torch.where(any_d & any_h, torch.where(fwd, p / q, q / p),
                       torch.ones_like(p))

    asgn_f = asgn[:R]
    hdrr_f, hdrr_b = hdrr[:R], hdrr[R:]
    m_f = m[:R]
    inb_f = inb[:R]
    flip_idx = torch.where(cols < m_f[:, None], m_f[:, None] - 1 - cols,
                           cols)
    asgn_b = torch.gather(asgn[R:], 1, flip_idx)

    eq = (~inb_f | (asgn_f == asgn_b)).all(1)
    nz = (asgn_f != 0) & inb_f

    def prefix_like(nzv, first_state):
        fz, has_z = _first_true(~nzv & inb_f)
        first_zero = torch.where(has_z, fz, m_f)
        any_nz_after = (nzv & (cols >= first_zero[:, None])).any(1)
        return (first_state == REPEAT) & ~any_nz_after

    is_prefix = prefix_like(nz, asgn_f[:, 0])
    rev_nz = torch.gather(nz, 1, flip_idx)
    lastv = _at(asgn_f, torch.clamp(m_f - 1, min=0))
    is_suffix = prefix_like(rev_nz, lastv)

    keep_f = (hdrr_f - 1.0).abs() <= (hdrr_b - 1.0).abs()
    take_b = ~eq & ~is_prefix & (is_suffix | ~keep_f)
    return torch.where(take_b[:, None], asgn_b, asgn_f)


def un_planes(U: dict, P: RelParams):
    """Per-interval planes of the relaxation (device_pipeline._un_planes):
    returns P13 f64 (Bn, max_n, 13), packL = (cce, e-1, ce) and packR =
    (ccb, b, cb) f64 (Bn, max_n, 3)."""
    f64 = torch.float64
    covHf = P.gcov[HAPLO].to(f64)
    covDf = P.gcov[DIPLO].to(f64)
    covEf = P.gcov[ERROR].to(f64)
    cb, ce = U["cb"].to(f64), U["ce"].to(f64)
    lf_cb, lf_ce = U["lf_cb"], U["lf_ce"]
    b, e1 = U["b"].to(f64), (U["e"] - 1).to(f64)

    def pois(k, lamf, lf_k):
        return k * torch.log(lamf) - lamf - lf_k

    lE = torch.maximum(U["pe"], pois(cb, covEf, lf_cb)
                       + pois(ce, covEf, lf_ce) + P.e_po_base)
    P13 = torch.stack([
        cb, ce, lf_cb, lf_ce, b, e1, lE,
        pois(cb, covHf, lf_cb), pois(ce, covHf, lf_ce),
        pois(cb, covDf, lf_cb), pois(ce, covDf, lf_ce),
        U["peob"], U["peoe"]], dim=-1)
    packL = torch.stack([U["cce"].to(f64), e1, ce], dim=-1)
    packR = torch.stack([U["ccb"].to(f64), b, cb], dim=-1)
    return P13, packL, packR


def _unrel(impl, *args):
    if callable(impl):          # a sweep with unrel_sweeps' contract (tests)
        return impl(*args)
    if impl == "cuda":
        from classpro_tpu_torch.kernels import unrel_sweeps

        return unrel_sweeps(*args)
    if impl == "ref":
        from classpro_tpu_torch.unrel_ref import unrel_sweeps_ref

        return unrel_sweeps_ref(*args)
    raise ValueError(f"unknown sweep impl {impl!r}")


def _risky(v):
    return (v > 0.0) & (v < REL_MARGIN_EPS)


def _drop(idx, size: int):
    """Indices outside [0, size) (the mode="drop" sentinels) -> size."""
    idx = idx.to(torch.int64)
    return torch.where((idx >= 0) & (idx < size), idx, size)


def _scatter_rel(asgn, rel_out, rel_rows, rel_cols) -> None:
    """asgn[rel_rows[j], rel_cols[j, c]] = rel_out[j, c] in place (the
    (Bn, max_n) interval rows); the sentinel indices (rel_rows = Bn,
    rel_cols = max_n) land in a spare row or column, which is cut off."""
    Bn, max_n = asgn.shape
    R, max_m = rel_out.shape
    rows = _drop(rel_rows, Bn)
    cols = _drop(rel_cols, max_n)
    asgn_x = torch.full((Bn + 1, max_n + 1), N_STATE, dtype=torch.int32,
                        device=asgn.device)
    asgn_x[:Bn, :max_n] = asgn
    asgn_x[rows[:, None].expand(R, max_m), cols] = rel_out.to(torch.int32)
    asgn.copy_(asgn_x[:Bn, :max_n])


def sweep_inputs(U: dict, rel_out, P: RelParams, Bn: int, max_n: int):
    """The relaxation sweeps' arguments for a chunk whose reconciled rel
    assignments are ``rel_out`` (R, max_m): (is_rel, asgn, P13, packL,
    packR, idx_desc, idx_asc, live, n), as unrel_sweeps takes them."""
    asgn = torch.full((Bn, max_n), N_STATE, dtype=torch.int32,
                      device=rel_out.device)
    _scatter_rel(asgn, rel_out, U["rel_rows"], U["rel_cols"])
    P13, packL, packR = un_planes(U, P)
    return (U["is_rel"] != 0, asgn, P13, packL, packR, U["idx_desc"],
            U["idx_asc"], U["live"] != 0, U["n"])


def prep_ref(fblob, iblob, P: RelParams, R: int, max_m: int, Bn: int,
             max_n: int):
    """kernels.rel_prep's plain version (all-device layout): the DP's
    planes, the first pass's coverages (2R, 4) and the sweeps' is_rel,
    asgn (all N_STATE), P13, packL, packR, live and the (2, Bn) margin
    gate (every read unflagged)."""
    R2 = 2 * R
    U = unpack(fblob, iblob, Bn, max_n, R2, max_m)
    P13, packL, packR = un_planes(U, P)
    dev = fblob.device
    gate = torch.tensor(GATE_UNFLAGGED, dtype=torch.float64, device=dev)
    un = {"is_rel": U["is_rel"] != 0,
          "asgn": torch.full((Bn, max_n), N_STATE, dtype=torch.int32,
                             device=dev),
          "P13": P13, "packL": packL, "packR": packR,
          "live": U["live"] != 0,
          "gate": gate[:, None].expand(2, Bn).contiguous()}
    return dp_planes(U, P), P.gcov[None, :].expand(R2, 4).contiguous(), un


def settle_ref(asgn1, asgn2, mm1, mm2, rescue, planes, rel_rows, rel_cols,
               P: RelParams, asgn, gate) -> None:
    """kernels.rel_settle's plain version: the pass merge, demote_rows and
    reconcile_dev on the DP's two passes, the reconciled rows scattered
    into ``asgn`` (Bn, max_n), and the ``gate`` (2, Bn) of every read with
    a risky rel margin opened to [-inf, inf]."""
    R2, max_m = asgn1.shape
    R = R2 // 2
    Bn = asgn.shape[0]
    asgn8, mm = merge_passes(asgn1, mm1, asgn2, mm2, rescue)
    U = dict(zip(_RE_PLANES[:4], planes[:4]), m=planes[7])
    rel2 = demote_rows(U, asgn8, rescue, P)
    _scatter_rel(asgn, reconcile_dev(rel2, planes[7], planes[1], planes[3],
                                     planes[9], R, max_m),
                 rel_rows, rel_cols)
    f = torch.zeros(Bn + 1, dtype=torch.int32, device=asgn.device)
    f.scatter_reduce_(0, _drop(rel_rows, Bn),
                      (_risky(mm[:R]) | _risky(mm[R:])).to(torch.int32),
                      "amax")
    gate[0].masked_fill_(f[:Bn] > 0, -math.inf)
    gate[1].masked_fill_(f[:Bn] > 0, math.inf)


def pack_flags(asgn, flags):
    """The packed result of a chunk: uint8 (Bn, max_n + 1), each read's
    assignment bytes, then its guard flag (0 or 1)."""
    return torch.cat([asgn.view(torch.uint8),
                      flags.to(torch.uint8)[:, None]], dim=1)


def gate_ref(asgn, un_mm, gate):
    """The sweep kernel's gate tail, plain: the rows ``asgn`` int8 (Bn,
    max_n) packed with each read's guard flag, risky(un_mm) or the read's
    rel flag as the margin ``gate`` (2, Bn) holds it.  The sweeps' margin
    is never NaN (a NaN step margin counts as 1e-30), so a flagged read's
    [-inf, inf] gate returns it unchanged."""
    return pack_flags(asgn, torch.clamp(un_mm, gate[0], gate[1]) == un_mm)


def classify_glued(fblob, iblob, P: PipelineParams, Bn: int, max_n: int,
                   R2: int, max_m: int, ops):
    """classify_batch as five launches: ``ops`` holds rel_prep,
    rel_dp_rescue, rel_dp, rel_settle and unrel_sweeps with the contracts
    of the kernels module's wrappers (the kernels on a card; the tests
    pass the g++ shims).  Returns the packed uint8 (Bn, max_n + 1)
    (``pack_flags``), which the sweeps' gate tail writes."""
    R = R2 // 2
    V = blob_views(fblob, iblob, Bn, max_n, R2, max_m)
    planes, cov, un = ops.rel_prep(fblob, iblob, P.rel, R, max_m,
                                   alldev=(Bn, max_n))
    asgn1, _dp1, mm1, rescue, cov2 = ops.rel_dp_rescue(*planes, cov, P.rel)
    asgn2, _dp2, mm2 = ops.rel_dp(*planes, cov2, P.rel, active=rescue)
    ops.rel_settle(asgn1, asgn2, mm1, mm2, rescue, planes, V["rel_rows"],
                   V["rel_cols"], P.rel, un["asgn"], un["gate"])
    packed, _un_mm = ops.unrel_sweeps(
        un["is_rel"], un["asgn"], un["P13"], un["packL"], un["packR"],
        V["idx_desc"], V["idx_asc"], un["live"], V["n"], P.unrel,
        gate=un["gate"])
    return packed


def blob_sizes(Bn: int, max_n: int, R2: int, max_m: int) -> tuple:
    """(fblob, iblob) element counts of an all-device chunk (the layout
    above)."""
    R = R2 // 2
    return (5 * Bn * max_n + 3 * R2 * max_m,
            10 * Bn * max_n + Bn + 5 * R2 * max_m + R * max_m + 3 * R2 + R)


# captures and replays of the all-device chunk's CUDA graphs in this
# process
GRAPH_COUNTS = {"captures": 0, "replays": 0}


class BatchGraph(BlobGraph):
    """The all-device chunk of one (Bn, max_n, R2, max_m) bucket of one
    PipelineParams on one card as one CUDA graph (rel.BlobGraph):
    ``classify_glued``'s five launches, their planes and K5's scratch in
    the graph's own pool; its output is the packed (Bn, max_n + 1) result
    (the JAX package jits classify_batch_dev once per bucket)."""

    COUNTS = GRAPH_COUNTS

    def __init__(self, P: PipelineParams, Bn: int, max_n: int, R2: int,
                 max_m: int):
        from classpro_tpu_torch import kernels

        self.P, self.dims = P, (Bn, max_n, R2, max_m)
        super().__init__(P.device, *blob_sizes(*self.dims),
                         lambda f, i: classify_glued(f, i, P, *self.dims,
                                                     kernels))


class BatchGraphs(GraphCache):
    """BatchGraphs by (device, Bn, max_n, R2, max_m) and PipelineParams (the
    object itself: its graph baked in the RelParams' and UnrelParams'
    pointers and scalars).  An engine keeps its own; ``GRAPHS`` serves
    ``classify_batch``."""

    def __init__(self):
        super().__init__(BatchGraph)


GRAPHS = BatchGraphs()


def classify_batch(fblob: torch.Tensor, iblob: torch.Tensor,
                   P: PipelineParams, Bn: int, max_n: int, R2: int,
                   max_m: int, impl=None):
    """Classify one packed read group on ``P``'s device
    (device_pipeline.classify_batch_dev).  ``impl``: "cuda" (the replay of
    the bucket's ``BatchGraph`` from the process-wide ``GRAPHS``, its
    packed output copied out of the static buffer), "ref" (the plain
    versions) or a pair (DP, sweeps) of callables with the kernels'
    contracts (the plain glue around them); the default follows the
    device.

    Returns (asgn int8 (Bn, max_n) per interval, flags bool (Bn,): reads
    whose rel or relaxation decisions fell inside the exactness-guard
    epsilon, which the caller re-decides exactly); on a card both are
    views of the packed result."""
    impl = impl or default_impl(fblob.device)
    if impl == "cuda":
        packed = GRAPHS.get(P, Bn, max_n, R2, max_m).run(fblob, iblob).clone()
        return (packed[:, :max_n].view(torch.int8),
                packed[:, max_n].view(torch.bool))
    dp_impl, un_impl = impl if isinstance(impl, tuple) else (impl, impl)
    R = R2 // 2
    U = unpack(fblob, iblob, Bn, max_n, R2, max_m)
    rel2, rel_mm, _ = rel_pipeline(U, P.rel, max_m, dp_impl)
    rel_out = reconcile_dev(rel2, U["m"], U["bcnt"], U["ecnt"], U["fwd"], R,
                            max_m)
    out, un_mm = _unrel(un_impl, *sweep_inputs(U, rel_out, P.rel, Bn,
                                                max_n), P.unrel)

    rel_risky = _risky(rel_mm[:R]) | _risky(rel_mm[R:])
    f = torch.cat([_risky(un_mm).to(torch.int32),
                   torch.zeros(1, dtype=torch.int32, device=fblob.device)])
    f.scatter_reduce_(0, _drop(U["rel_rows"], Bn), rel_risky.to(torch.int32),
                      "amax")
    return out, f[:Bn] > 0
