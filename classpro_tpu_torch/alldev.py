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
"""

from __future__ import annotations

import torch

from classpro_tpu_torch.params import PipelineParams, RelParams
from classpro_tpu_torch.rel import (REL_MARGIN_EPS, default_impl,
                                    e_emission, rel_pipeline as _rel_dp)

ERROR, REPEAT, HAPLO, DIPLO, N_STATE = 0, 1, 2, 3, 4

_RE_PLANES = ("bpos", "bcnt", "epos", "ecnt", "max_cc")


def unpack(fblob: torch.Tensor, iblob: torch.Tensor, Bn: int, max_n: int,
           R2: int, max_m: int) -> dict:
    """Views of the two blobs (device_pipeline._unpack); the rel planes
    and m, plen as int64, fwd as bool."""
    R = R2 // 2
    un_sz, rel_sz = Bn * max_n, R2 * max_m
    i64 = torch.int64
    U = {}
    o = 0
    for k in ("b", "e", "cb", "ce", "ccb", "cce", "idx_desc", "idx_asc",
              "is_rel", "live"):
        U[k] = iblob[o:o + un_sz].reshape(Bn, max_n)
        o += un_sz
    U["n"] = iblob[o:o + Bn]
    o += Bn
    for k in _RE_PLANES:
        U[k] = iblob[o:o + rel_sz].reshape(R2, max_m).to(i64)
        o += rel_sz
    U["rel_cols"] = iblob[o:o + R * max_m].reshape(R, max_m)
    o += R * max_m
    for k in ("m", "plen"):
        U[k] = iblob[o:o + R2].to(i64)
        o += R2
    U["fwd"] = iblob[o:o + R2] != 0
    o += R2
    U["rel_rows"] = iblob[o:o + R]

    of = 0
    for k in ("pe", "peob", "peoe", "lf_cb", "lf_ce"):
        U[k] = fblob[of:of + un_sz].reshape(Bn, max_n)
        of += un_sz
    for k in ("pe_rel", "lf_bcnt", "lf_ecnt"):
        U[k] = fblob[of:of + rel_sz].reshape(R2, max_m)
        of += rel_sz
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


def sweep_inputs(U: dict, rel_out, P: RelParams, Bn: int, max_n: int):
    """The relaxation sweeps' arguments for a chunk whose reconciled rel
    assignments are ``rel_out`` (R, max_m): (is_rel, asgn, P13, packL,
    packR, idx_desc, idx_asc, live, n), as unrel_sweeps takes them."""
    R, max_m = rel_out.shape
    # rel assignments into the (Bn, max_n) interval rows; the sentinel
    # indices (rel_rows = Bn, rel_cols = max_n) land in a spare row or
    # column, which is cut off
    rows = _drop(U["rel_rows"], Bn)
    cols = _drop(U["rel_cols"], max_n)
    asgn_x = torch.full((Bn + 1, max_n + 1), N_STATE, dtype=torch.int32,
                        device=rel_out.device)
    asgn_x[rows[:, None].expand(R, max_m), cols] = rel_out.to(torch.int32)
    P13, packL, packR = un_planes(U, P)
    return (U["is_rel"] != 0, asgn_x[:Bn, :max_n].contiguous(), P13, packL,
            packR, U["idx_desc"], U["idx_asc"], U["live"] != 0, U["n"])


def classify_batch(fblob: torch.Tensor, iblob: torch.Tensor,
                   P: PipelineParams, Bn: int, max_n: int, R2: int,
                   max_m: int, impl=None):
    """Classify one packed read group on ``P``'s device
    (device_pipeline.classify_batch_dev).  ``impl``: "cuda" (the kernels),
    "ref" (the plain versions) or a pair (DP, sweeps) of callables with
    the kernels' contracts; the default follows the device.

    Returns (asgn int8 (Bn, max_n) per interval, flags bool (Bn,): reads
    whose rel or relaxation decisions fell inside the exactness-guard
    epsilon, which the caller re-decides exactly)."""
    impl = impl or default_impl(fblob.device)
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
