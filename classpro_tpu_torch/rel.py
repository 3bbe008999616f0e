"""Per-chunk reliable-interval stage: torch glue around the DP kernel,
plus the host steps that follow it.

``rel_only`` is the counterpart of the JAX package's ``rel_only_dev``
(``_rel_only_core`` + ``_rel_pipeline(demotes=False)`` + ``_pack_out``):
it takes the C++ ``pack_rel`` blobs, derives both scan directions, runs
the DP, the no-H rescue predicate and the rescue pass, and packs one
uint8 array (2R, max_m+5).  On a card (``impl="cuda"``) that is two
launches of the DP kernel of csrc/rel_dp.cu (``rel_glued``): the first
pass with its prologue (the planes from the blobs) and its rescue and
pack tails, the rescue pass with its pack tail; the two are captured
once per (device, R, max_m) bucket and model in a CUDA graph
(``ChunkGraph``, cached by ``RelGraphs``), which each chunk replays, as
the JAX package runs one AOT-compiled program per bucket.  ``impl="ref"``
runs the plain versions: ``rel_planes`` (``prep_ref``), the plain DP
(rel_ref), ``rescue_rows`` and ``pack_ref``, which are what the kernels
are held against.  ``unpack_out``, ``demote_host`` and
``reconcile_fwbw`` are numpy copies of the JAX package's host steps.
"""

from __future__ import annotations

import numpy as np
import torch

from classpro_tpu_torch.constants import REL_MARGIN_EPS
from classpro_tpu_torch.params import RelParams

ERROR, REPEAT, HAPLO, DIPLO, N_STATE = 0, 1, 2, 3, 4


def default_impl(device) -> str:
    """The CUDA kernel on a card, the plain torch DP on the CPU."""
    return "cuda" if torch.device(device).type == "cuda" else "ref"


def _dp(impl, planes, cov, P, active=None):
    if callable(impl):          # a DP with rel_dp's contract (tests)
        return impl(*planes, cov, P, active=active)
    if impl == "cuda":
        from classpro_tpu_torch.kernels import rel_dp

        return rel_dp(*planes, cov, P, active=active)
    if impl == "ref":
        from classpro_tpu_torch.rel_ref import rel_dp_ref

        return rel_dp_ref(*planes, cov, P)
    raise ValueError(f"unknown DP impl {impl!r}")


def e_emission(bcnt, ecnt, lf_bcnt, lf_ecnt, pe_rel, P: RelParams):
    """The DP's E emission plane (data-only, shared by the main and
    rescue passes): max(Poisson(bcnt) + Poisson(ecnt) at the E coverage
    + e_po_base, the wall's own error log-probability)."""
    covEf = P.gcov[ERROR].to(torch.float64)
    lce = torch.log(covEf)
    return torch.maximum(
        (bcnt.to(torch.float64) * lce - covEf - lf_bcnt)
        + (ecnt.to(torch.float64) * lce - covEf - lf_ecnt) + P.e_po_base,
        pe_rel)


def rel_planes(fblob: torch.Tensor, iblob: torch.Tensor, P: RelParams,
               R: int, max_m: int):
    """Both scan directions from the forward-order blobs:
    iblob (int32): b,e,ccb,cce [4 x R*max_m] | m [R] | plen [R];
    fblob (f64): pe [R*max_m].  Returns the DP's plane tuple (bpos, bcnt,
    epos, ecnt, max_cc, lf_bcnt, logpE, m, plen, fwd), backward rows
    index-reversed, and lf_ecnt."""
    sz = R * max_m
    i64 = torch.int64
    b = iblob[0:sz].reshape(R, max_m).to(i64)
    e = iblob[sz:2 * sz].reshape(R, max_m).to(i64)
    ccb = iblob[2 * sz:3 * sz].reshape(R, max_m).to(i64)
    cce = iblob[3 * sz:4 * sz].reshape(R, max_m).to(i64)
    m = iblob[4 * sz:4 * sz + R].to(i64)
    plen = iblob[4 * sz + R:4 * sz + 2 * R].to(i64)
    pe = fblob[0:sz].reshape(R, max_m)

    cols = torch.arange(max_m, device=iblob.device)
    flip = torch.where(cols[None, :] < m[:, None],
                       m[:, None] - 1 - cols[None, :], cols[None, :])
    max_cc = torch.maximum(ccb, cce)

    def rev(a):
        return torch.gather(a, 1, flip)

    bcnt = torch.cat([ccb, rev(cce)])
    ecnt = torch.cat([cce, rev(ccb)])
    lf = P.logfact
    lf_bcnt = lf[torch.clamp(bcnt, 0, 32767)]
    lf_ecnt = lf[torch.clamp(ecnt, 0, 32767)]
    bpos = torch.cat([b, rev(e) - 1])
    epos = torch.cat([e - 1, rev(b)])
    pe_rel = torch.cat([pe, rev(pe)])

    logpE = e_emission(bcnt, ecnt, lf_bcnt, lf_ecnt, pe_rel, P)
    fwd = torch.cat([torch.ones(R, dtype=torch.bool, device=iblob.device),
                     torch.zeros(R, dtype=torch.bool, device=iblob.device)])
    planes = (bpos, bcnt, epos, ecnt, torch.cat([max_cc, rev(max_cc)]),
              lf_bcnt, logpE, torch.cat([m, m]), torch.cat([plen, plen]),
              fwd)
    return planes


def prep_ref(fblob: torch.Tensor, iblob: torch.Tensor, P: RelParams,
             R: int, max_m: int):
    """The plain version of kernels.rel_dp_first's prologue: the DP's
    planes and the first pass's coverages (2R, 4)."""
    cov = P.gcov[None, :].expand(2 * R, 4).contiguous()
    return rel_planes(fblob, iblob, P, R, max_m), cov


def rescue_rows(planes, asgn8, P: RelParams, max_m: int):
    """The no-H rescue predicate (class_rel.c:630-672 / 744-784) on a
    first pass's assignments: returns (rescue bool (R2,), the rescue
    pass's coverages cov2 int64 (R2, 4)).  The plain version of
    kernels.rel_dp_rescue's rescue tail."""
    bpos, bcnt, epos, ecnt = planes[:4]
    m = planes[7]
    R2 = bpos.shape[0]
    cov_t = P.gcov[None, :].expand(R2, 4)
    asgn = asgn8.to(torch.int64)
    cols = torch.arange(max_m, device=bpos.device)[None, :]
    inb = cols < m[:, None]
    l_arr = torch.abs(epos - bpos) + 1
    # the predicate in exact int64 (cross-multiplied mean comparison);
    # one keyed min carries the first-D column and its entering count
    dmask = inb & (asgn == DIPLO)
    zero = torch.zeros_like(l_arr)
    lsum = torch.where(dmask, l_arr, zero).sum(1)
    csum = torch.where(dmask, torch.div((bcnt + ecnt) * l_arr, 2,
                                        rounding_mode="floor"), zero).sum(1)
    no_h = (inb & (asgn == HAPLO)).sum(1) == 0
    big = max_m << 16
    key = torch.where(dmask, (cols << 16) + bcnt,
                      torch.full_like(bcnt, big)).amin(1)
    anchor_cnt = key & 0xFFFF
    rescue = no_h & (key < big) & (csum < cov_t[:, DIPLO] * lsum)
    cov2 = cov_t.clone()
    cov2[:, HAPLO] = torch.where(rescue, anchor_cnt, cov_t[:, HAPLO])
    cov2[:, DIPLO] = torch.where(rescue, anchor_cnt + P.gcov[HAPLO],
                                 cov_t[:, DIPLO])
    return rescue, cov2


def rel_pipeline(planes, P: RelParams, max_m: int, impl):
    """DP + no-H rescue pass -> (asgn int8 (2R, max_m), margin f64 (2R,),
    rescue bool (2R,))."""
    R2 = planes[0].shape[0]
    cov_t = P.gcov[None, :].expand(R2, 4).contiguous()
    asgn8, _dp1, mm1 = _dp(impl, planes, cov_t, P)
    rescue, cov2 = rescue_rows(planes, asgn8, P, max_m)
    if impl == "ref" and not bool(rescue.any()):
        asgn2, mm2 = asgn8, mm1
    else:
        # the kernel's second launch runs only the rescued rows (the
        # rest exit at once), so no host sync tests any(rescue)
        asgn2, _dp2, mm2 = _dp(impl, planes, cov2, P, active=rescue)
    out, mm = merge_passes(asgn8, mm1, asgn2, mm2, rescue)
    return out, mm, rescue


def merge_passes(asgn1, mm1, asgn2, mm2, rescue):
    """The rescued rows' second-pass assignments; their margin the min of
    both passes' (their decisions came from both)."""
    out = torch.where(rescue[:, None], asgn2, asgn1)
    return out, torch.where(rescue, torch.minimum(mm1, mm2), mm1)


def pack_ref(asgn1, asgn2, mm1, mm2, rescue) -> torch.Tensor:
    """The pass merge and pack_out: the plain version of the pack tails of
    kernels.rel_dp_first (the rows not rescued) and rel_dp_pack (the
    rescued rows)."""
    asgn, mm = merge_passes(asgn1, mm1, asgn2, mm2, rescue)
    return pack_out(asgn, mm, rescue, asgn.shape[1])


def pack_out(asgn, mm, rescue, max_m: int) -> torch.Tensor:
    """One uint8 array (2R, max_m+5): [asgn bytes | flags (bit0 risky,
    bit1 rescue) | f32(margin) x4, little-endian]."""
    risky = (mm > 0.0) & (mm < REL_MARGIN_EPS)          # f64, exact
    flags = risky.to(torch.uint8) | (rescue.to(torch.uint8) << 1)
    mm32 = mm.to(torch.float32).contiguous().view(torch.uint8).reshape(-1, 4)
    return torch.cat([asgn.view(torch.uint8), flags[:, None], mm32], dim=1)


def rel_only(fblob: torch.Tensor, iblob: torch.Tensor, P: RelParams,
             R: int, max_m: int, impl: str | None = None) -> torch.Tensor:
    """The rel stage of one chunk on ``P``'s device (JAX rel_only_dev):
    returns the packed uint8 (2R, max_m+5) result — fw rows then bw rows
    in scan order, post-rescue, pre-demotion.  ``impl``: "cuda" (the
    replay of the bucket's ``ChunkGraph`` from the process-wide
    ``GRAPHS``, the result copied out of its static buffer), "ref" (the
    plain versions) or a DP callable with rel_dp's contract (the plain
    glue around it)."""
    impl = impl or default_impl(P.device)
    if impl == "cuda":
        return GRAPHS.get(P, R, max_m).run(fblob, iblob).clone()
    planes = rel_planes(fblob, iblob, P, R, max_m)
    asgn, mm, rescue = rel_pipeline(planes, P, max_m, impl)
    return pack_out(asgn, mm, rescue, max_m)


def rel_glued(fblob, iblob, P: RelParams, R: int, max_m: int, ops):
    """rel_only as two launches: ``ops`` holds rel_dp_first and
    rel_dp_pack with the contracts of the kernels module's wrappers (the
    kernels on a card; the tests pass the g++ shims).  The first pass
    writes the planes and packs the rows it does not rescue, the rescue
    pass runs and packs the rescued rows only (the others exit at once),
    so no host sync tests any(rescue)."""
    planes, _cov, _a1, _dp1, mm1, rescue, cov2, packed = ops.rel_dp_first(
        fblob, iblob, P, R, max_m)
    ops.rel_dp_pack(*planes, cov2, P, rescue, mm1, packed)
    return packed


def blob_sizes(R: int, max_m: int) -> tuple:
    """(fblob, iblob) element counts of a main-layout chunk (C++
    ``pack_rel``: pe; b, e, ccb, cce, m, plen)."""
    return R * max_m, 4 * R * max_m + 2 * R


# captures and replays of the main chunk's CUDA graphs in this process
GRAPH_COUNTS = {"captures": 0, "replays": 0}


def _launch_counts() -> dict:
    from classpro_tpu_torch import kernels

    return {"launches": dict(kernels.LAUNCHES),
            "tails": dict(kernels.TAIL_LAUNCHES)}


class BlobGraph:
    """One chunk's launches on one card as one CUDA graph: ``glued(fblob,
    iblob)`` (-> one output tensor), captured once on static blobs of
    ``n_f`` f64 and ``n_i`` int32 elements; a chunk copies its blobs into
    them, replays the graph and reads the static output (the JAX package
    compiles one program per bucket).  ``ChunkGraph`` (the main chunk) and
    ``alldev.BatchGraph`` (the all-device chunk) are its two kinds, each
    counting its captures and replays in its ``COUNTS``.

    Capture: the launches first run eagerly on padding blobs (-inf, ones;
    the kernels' libraries load their modules lazily, and a first
    launch's API calls would break a capture), then ``glued`` is captured
    on a side stream into a memory pool of the graph's own (buckets
    replay in any order, so they share none; the pool also holds the
    launches' scratch for as long as the graph lives).  The kernels'
    launch counts that the capture made are taken back and added at every
    replay, which runs those launches.  A failed capture or replay
    raises.

    The static buffers are reused by every chunk: ``run`` copies in,
    replays and hands back the output on the current stream, and the
    caller copies it out on that same stream, so the stream orders each
    chunk's use of the buffers before the next chunk's, with any number
    of chunks in flight."""

    COUNTS: dict

    def __init__(self, device: torch.device, n_f: int, n_i: int, glued):
        from classpro_tpu_torch import kernels

        if device.type != "cuda":
            raise ValueError(f"a chunk graph needs a CUDA card, not {device}")
        self.fblob = torch.full((n_f,), -float("inf"), dtype=torch.float64,
                                device=device)
        self.iblob = torch.ones(n_i, dtype=torch.int32, device=device)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device), torch.cuda.stream(side):
            glued(self.fblob, self.iblob)
            side.synchronize()
            before = _launch_counts()
            self.graph.capture_begin()
            try:
                self.out = glued(self.fblob, self.iblob)
            except BaseException:
                try:
                    self.graph.capture_end()
                except RuntimeError:
                    pass            # the capture was invalidated already
                raise
            finally:
                after = _launch_counts()
                kernels.LAUNCHES.update(before["launches"])
                kernels.TAIL_LAUNCHES.update(before["tails"])
            self.graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(side)
        self.counts = {g: {k: after[g][k] - before[g][k] for k in after[g]}
                       for g in after}
        self.COUNTS["captures"] += 1

    def replay(self) -> None:
        """Replay the graph on the current stream; count its launches."""
        from classpro_tpu_torch import kernels

        self.graph.replay()
        for k, n in self.counts["launches"].items():
            kernels.LAUNCHES[k] += n
        for k, n in self.counts["tails"].items():
            kernels.TAIL_LAUNCHES[k] += n
        self.COUNTS["replays"] += 1

    def run(self, fblob: torch.Tensor, iblob: torch.Tensor) -> torch.Tensor:
        """One chunk on the current stream: its blobs (on the host, pinned
        for an asynchronous copy, or on the card) into the static inputs,
        the replay; returns the static output, which the next run
        overwrites."""
        for name, got, want in (("fblob", fblob, self.fblob),
                                ("iblob", iblob, self.iblob)):
            if got.dtype != want.dtype or got.shape != want.shape:
                raise ValueError(f"{name}: want {want.dtype} "
                                 f"{tuple(want.shape)}, got {got.dtype} "
                                 f"{tuple(got.shape)}")
        self.fblob.copy_(fblob, non_blocking=True)
        self.iblob.copy_(iblob, non_blocking=True)
        self.replay()
        return self.out


class ChunkGraph(BlobGraph):
    """The main chunk of one (R, max_m) bucket of one RelParams on one card
    (``rel_glued``'s two launches of the DP kernel: the first pass with
    its prologue and tails, the rescue pass with its pack tail); its
    output is the packed (2R, max_m + 5) result (the JAX package compiles
    rel_only_dev once per bucket, engine._rel_exec)."""

    COUNTS = GRAPH_COUNTS

    def __init__(self, P: RelParams, R: int, max_m: int):
        from classpro_tpu_torch import kernels

        self.P, self.R, self.max_m = P, R, max_m
        super().__init__(P.device, *blob_sizes(R, max_m),
                         lambda f, i: rel_glued(f, i, P, R, max_m, kernels))


class GraphCache:
    """Graphs by (device, *shape) and model, made by ``make(P, *shape)`` at
    first use.  An entry holds the parameters whose pointers and scalars
    its graph baked in and is found only for that same object, so no
    graph replays another model's tables (the JAX package keys its
    executables with the parameters' signature, engine._rel_exec)."""

    def __init__(self, make):
        self._make = make
        self._graphs: dict = {}

    def get(self, P, *shape):
        bucket = self._graphs.setdefault((P.device,) + shape, [])
        for g in bucket:
            if g.P is P:
                return g
        g = self._make(P, *shape)
        bucket.append(g)
        return g

    def __len__(self) -> int:
        return sum(len(b) for b in self._graphs.values())


class RelGraphs(GraphCache):
    """ChunkGraphs by (device, R, max_m) and RelParams.  An engine keeps
    its own (its RelParams live as long as it does); ``GRAPHS`` serves
    ``rel_only``."""

    def __init__(self):
        super().__init__(ChunkGraph)


GRAPHS = RelGraphs()


def unpack_out(buf, max_m: int):
    """Host-side split of pack_out's array: returns (asgn int8
    (2R, max_m), risky bool, rescue bool, margin f32 (2R,))."""
    buf = np.ascontiguousarray(buf)
    v = buf[:, :max_m].view(np.int8)
    flags = buf[:, max_m]
    mm = buf[:, max_m + 1: max_m + 5].copy().view(np.float32).ravel()
    return v, (flags & 1) != 0, (flags & 2) != 0, mm


def demote_host(rel2: "np.ndarray", rescue: "np.ndarray",
                b: "np.ndarray", e: "np.ndarray", ccb: "np.ndarray",
                cce: "np.ndarray", m: "np.ndarray", gH: int,
                gD: int) -> "np.ndarray":
    """Post-rescue demotions (class_rel.c:650-713) in exact int64: the
    cross-multiplied mean-vs-threshold comparisons are bit-equivalent to
    the reference's double division.  Applied per scan-direction row
    before the fw/bw reconciliation.

    rel2: (2R, max_m) int8 (fw rows then bw rows in scan order);
    rescue: (2R,) bool no-H rescue flags; b/e/ccb/cce: (R, max_m)
    forward-order interval bounds + corrected counts; m: (R,) live
    counts.  Returns the demoted copy (rel2 is not mutated)."""
    R, max_m = b.shape
    mv = np.asarray(m, np.int64)
    cols = np.arange(max_m)[None, :]
    inb1 = cols < mv[:, None]
    inb = np.concatenate([inb1, inb1])
    m2 = np.concatenate([mv, mv])
    asgn = np.array(rel2, copy=True)   # int8 work copy (flips in place)
    gHi = np.int64(gH)
    gDi = np.int64(gD)

    # the heavy int64 planes are built only for candidate rows; flips
    # apply in place between stages because each stage's mask reads the
    # previous stage's result (class_rel.c:650-713 sequencing)
    def planes(rows):
        """l/bcnt/ecnt int64 planes (scan order) for 2R-row indices."""
        rr = rows % R
        bs = b[rr].astype(np.int64)
        es = e[rr].astype(np.int64)
        cbs = ccb[rr].astype(np.int64)
        ces = cce[rr].astype(np.int64)
        l = np.abs((es - 1) - bs) + 1
        bc, ec = cbs, ces
        bw = np.nonzero(rows >= R)[0]
        if bw.size:
            mvk = mv[rr[bw]]
            fi = np.where(cols < mvk[:, None], mvk[:, None] - 1 - cols,
                          cols)
            l[bw] = np.take_along_axis(l[bw], fi, axis=1)
            bc = bc.copy()
            ec = ec.copy()
            bc[bw] = np.take_along_axis(ces[bw], fi, axis=1)
            ec[bw] = np.take_along_axis(cbs[bw], fi, axis=1)
        return l, bc, ec

    # ---- no-H rescue rows: D -> H when the D-run mean sits nearer gH
    no_h2 = np.asarray(rescue, bool) & ~(inb & (asgn == HAPLO)).any(axis=1)
    rows = np.nonzero(no_h2)[0]
    if rows.size:
        l, bc, ec = planes(rows)
        mask = inb[rows] & (asgn[rows] == DIPLO)
        lsum = np.where(mask, l, 0).sum(axis=1)
        csum = np.where(mask, (bc + ec) * l // 2, 0).sum(axis=1)
        flip = (lsum > 0) & (np.abs(csum - gHi * lsum)
                             <= np.abs(csum - gDi * lsum))
        fr = rows[flip]
        sub = asgn[fr]
        asgn[fr] = np.where(sub == DIPLO, HAPLO, sub)

    # ---- all-H rows: H -> D when the row mean sits nearer (or tied) gD
    # (m2 == 0 padding rows are vacuously all-H with nothing to flip)
    all_h = (~inb | (asgn == HAPLO)).all(axis=1) & (m2 > 0)
    rows = np.nonzero(all_h)[0]
    if rows.size:
        l, bc, ec = planes(rows)
        ib = inb[rows]
        lsum = np.where(ib, l, 0).sum(axis=1)
        csum = np.where(ib, (bc + ec) * l // 2, 0).sum(axis=1)
        flip = np.abs(csum - gHi * lsum) >= np.abs(csum - gDi * lsum)
        fr = rows[flip]
        sub = asgn[fr]
        asgn[fr] = np.where((sub == HAPLO) & inb[fr], DIPLO, sub)

    # ---- >=70%-H rows: demote H -> D and D -> R together
    n_h = (inb & (asgn == HAPLO)).sum(axis=1)
    many_h = (n_h >= m2 * 0.7) & (m2 > 0)   # 0 >= 0.0 is vacuous: no-op
    rows = np.nonzero(many_h)[0]
    if rows.size:
        l, bc, ec = planes(rows)
        mask = inb[rows] & (asgn[rows] == HAPLO)
        lsum = np.where(mask, l, 0).sum(axis=1)
        csum = np.where(mask, (bc + ec) * l // 2, 0).sum(axis=1)
        dem = (lsum > 0) & (np.abs(csum - gHi * lsum)
                            >= np.abs(csum - gDi * lsum))
        fr = rows[dem]
        sub = asgn[fr]
        ib = inb[fr]
        sub = np.where((sub == DIPLO) & ib, REPEAT,
                       np.where((sub == HAPLO) & ib, DIPLO, sub))
        asgn[fr] = sub
    return asgn.astype(rel2.dtype, copy=False)


def reconcile_fwbw(rel2: "np.ndarray", ccb: "np.ndarray",
                   cce: "np.ndarray", m: "np.ndarray") -> "np.ndarray":
    """fw/bw reconciliation (class_rel.c:847-938) on the host, IEEE.

    rel2: (2R, max_m) int8 (fw rows then bw rows, bw in scan order);
    ccb/cce: (R, max_m) corrected counts in forward order; m: (R,) live
    interval counts.  Returns the reconciled (R, max_m) forward-order
    assignment.  The hdrr test |hdrr_f-1| <= |hdrr_b-1| sits exactly on
    its boundary for symmetric reads and keeps the forward pass there,
    as the reference does."""
    R = rel2.shape[0] // 2
    max_m = rel2.shape[1]
    out = rel2[:R].copy()
    # rows where fw == reversed-bw (the common case) need no work
    cols = np.arange(max_m)[None, :]
    mv = np.asarray(m)[:, None]
    flip = np.where(cols < mv, mv - 1 - cols, cols)
    bw_all = np.take_along_axis(rel2[R:], flip, axis=1)
    ineq = ((rel2[:R] != bw_all) & (cols < mv)).any(axis=1)
    for j in np.nonzero(ineq)[0]:
        mm = int(m[j])
        if mm <= 0:
            continue
        fw = rel2[j, :mm]
        bw = rel2[R + j, :mm][::-1]

        # is_eq_prefix / is_eq_suffix (class_rel.c:847-869)
        def pref(a):
            if a[0] != REPEAT:
                return False
            i = 0
            while i < mm and a[i]:
                i += 1
            return not a[i:].any()

        if pref(fw):
            continue
        if pref(fw[::-1]):
            out[j, :mm] = bw
            continue

        def hdrr_of(a):
            d = np.nonzero(a == DIPLO)[0]
            h = np.nonzero(a == HAPLO)[0]
            if len(d) == 0 or len(h) == 0:
                return 1.0
            return ((float(ccb[j, d[0]]) / float(ccb[j, h[0]]))
                    / (float(cce[j, d[-1]]) / float(cce[j, h[-1]])))

        if abs(hdrr_of(fw) - 1.0) <= abs(hdrr_of(bw) - 1.0):
            continue
        out[j, :mm] = bw
    return out
