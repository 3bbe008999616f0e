"""Blob packing and class expansion of the all-device path: the plain
numpy versions.

Copies of the JAX package's ``engine.pack_chunk`` and ``expand_asgn``:
``pack_chunk`` turns one read group's wall-stage records into the two
transfer blobs of ``alldev.classify_batch`` (layout in alldev.py), and
``expand_asgn`` turns the per-interval assignments that come back into
class strings.  The records are ``native._IVDT`` rows, read ``i``'s being
``slab[i*slot : i*slot+n_out[i]]`` of the C++ wall slab.  The engine runs
their C++ counterparts, ``native.NativeWall.pack_chunk`` and
``expand_rows``, which write the same blobs and class lines; these stay
as the reference the tests and chip_smoke.py hold them to.
"""

from __future__ import annotations

import numpy as np

from classpro_tpu_torch.numerics import LOGFACT

NEG_INF = float("-inf")


def _bucket(x: int, lo: int = 8) -> int:
    """Round up to the next power of two (bounds the shapes seen)."""
    b = lo
    while b < x:
        b *= 2
    return b


def _bucket32(x: int) -> int:
    """Round up to a multiple of 32 (scan-length padding granularity)."""
    return max(32, (x + 31) // 32 * 32)


def expand_asgn(asgn_fin, meta, res, K) -> None:
    """Per-interval assignments -> class strings (one flat repeat);
    writes res[i] for each read index i in meta's rows (the interval
    expansion of ClassPro.c:265-270)."""
    rows, ns, cat, row_flat, col_flat = meta[:5]
    stoc_lut = np.frombuffer(b"ERHD", dtype=np.uint8)
    lens_flat = (cat["e"] - cat["b"]).astype(np.int64)
    asgn_flat = np.clip(asgn_fin[row_flat, col_flat], 0, 3).astype(np.int64)
    body_all = stoc_lut[np.repeat(asgn_flat, lens_flat)].tobytes()
    read_off = np.zeros(len(rows) + 1, np.int64)
    np.cumsum(np.add.reduceat(lens_flat, np.cumsum([0] + ns[:-1])),
              out=read_off[1:])
    prefix = "N" * (K - 1)
    for r, i in enumerate(rows):
        res[i] = prefix + body_all[
            read_off[r]: read_off[r + 1]].decode("ascii")


def pack_chunk(rows, ivs, plens):
    """Pack one read group's wall-stage records (``ivs[i]`` for i in
    ``rows``, each with at least one record; ``plens[i]`` its profile
    length) into the two transfer blobs.  Returns (fblob, iblob,
    (Bn, max_n, R2, max_m), expand metadata)."""
    ns = [len(ivs[i]) for i in rows]
    Bn = _bucket(len(rows))
    max_n = _bucket32(max(ns))
    cols_n = np.arange(max_n)

    # vectorized scatter of the concatenated wall-stage records
    cat = np.concatenate([ivs[i] for i in rows])
    n_pad = np.zeros(Bn, np.int32)
    n_pad[: len(rows)] = ns
    row_flat = np.repeat(np.arange(len(rows)), ns)
    col_flat = np.arange(len(cat)) - np.repeat(
        np.cumsum([0] + ns[:-1]), ns)

    fI = {}
    for k in ("b", "e", "cb", "ce", "ccb", "cce"):
        v = np.zeros((Bn, max_n), np.int32)
        if k == "e":
            v[:] = 1
        v[row_flat, col_flat] = cat[k]
        fI[k] = v
    fF = {}
    for k, src in (("pe", "pe"), ("peob", "pe_o_b"), ("peoe", "pe_o_e")):
        v = np.full((Bn, max_n), NEG_INF)
        v[row_flat, col_flat] = cat[src]
        fF[k] = v
    for k, cnt in (("lf_cb", "cb"), ("lf_ce", "ce")):
        v = np.zeros((Bn, max_n))
        v[row_flat, col_flat] = LOGFACT[np.minimum(cat[cnt], 32767)]
        fF[k] = v
    is_rel = np.zeros((Bn, max_n), np.int32)
    is_rel[row_flat, col_flat] = cat["is_rel"]

    # processing orders of the two relaxation sweeps: by min(cb, ce)
    live_n = cols_n[None, :] < n_pad[:, None]
    keys = np.where(live_n, np.minimum(fI["cb"], fI["ce"]),
                    np.int64(1) << 40)
    iord = np.argsort(keys, axis=1, kind="stable").astype(np.int32)
    pos_desc = np.clip(n_pad[:, None] - 1 - cols_n[None, :], 0, max_n - 1)
    idx_desc = np.take_along_axis(iord, pos_desc, axis=1)
    idx_desc[~live_n] = 0
    idx_asc = np.where(live_n, iord, 0)

    # ---- reliable-interval batch (merged fw + bw rows) ---------------
    rel_flat = np.nonzero(cat["is_rel"])[0]
    rows_of_rel = row_flat[rel_flat]
    counts = np.bincount(rows_of_rel, minlength=len(rows))
    rel_pos = np.nonzero(counts)[0]
    R = _bucket(max(len(rel_pos), 1))
    max_m = _bucket32(int(counts.max()) if len(rel_pos) else 1)

    # row index in the rel batch for each read row; column within row
    j_of_row = np.full(len(rows), -1, np.int64)
    j_of_row[rel_pos] = np.arange(len(rel_pos))
    start = np.zeros(len(rows) + 1, np.int64)
    np.cumsum(counts, out=start[1:])
    within = np.arange(len(rel_flat)) - start[rows_of_rel]
    jj = j_of_row[rows_of_rel]

    rb = {k: np.zeros((R, max_m), np.int32)
          for k in ("b", "e", "ccb", "cce")}
    rb["e"][:] = 1
    rb["ccb"][:] = 1
    rb["cce"][:] = 1
    rb_pe = np.full((R, max_m), NEG_INF)
    for k in ("b", "e", "ccb", "cce"):
        rb[k][jj, within] = cat[k][rel_flat]
    rb_pe[jj, within] = cat["pe"][rel_flat]
    m_rel = np.ones(R, np.int32)
    m_rel[: len(rel_pos)] = counts[rel_pos]
    plen_rel = np.ones(R, np.int32)
    plen_rel[: len(rel_pos)] = [plens[rows[r]] for r in rel_pos]
    rel_rows_arr = np.full(R, Bn, np.int32)            # sentinel: drop
    rel_rows_arr[: len(rel_pos)] = rel_pos
    rel_cols = np.full((R, max_m), max_n, np.int32)    # sentinel: drop
    rel_cols[jj, within] = col_flat[rel_flat]
    cols_m = np.arange(max_m)

    max_cc_o = np.maximum(rb["ccb"], rb["cce"])
    lf_ccb = LOGFACT[np.minimum(rb["ccb"], 32767)]
    lf_cce = LOGFACT[np.minimum(rb["cce"], 32767)]
    flip = np.where(cols_m[None, :] < m_rel[:, None],
                    m_rel[:, None] - 1 - cols_m[None, :],
                    cols_m[None, :])

    def rev(a):
        return np.take_along_axis(a, flip, axis=1)

    iblob = np.concatenate([
        fI["b"].ravel(), fI["e"].ravel(), fI["cb"].ravel(),
        fI["ce"].ravel(), fI["ccb"].ravel(), fI["cce"].ravel(),
        idx_desc.ravel(), idx_asc.ravel(), is_rel.ravel(),
        live_n.astype(np.int32).ravel(), n_pad,
        np.concatenate([rb["b"], rev(rb["e"]) - 1]).ravel(),
        np.concatenate([rb["ccb"], rev(rb["cce"])]).ravel(),
        np.concatenate([rb["e"] - 1, rev(rb["b"])]).ravel(),
        np.concatenate([rb["cce"], rev(rb["ccb"])]).ravel(),
        np.concatenate([max_cc_o, rev(max_cc_o)]).ravel(),
        rel_cols.ravel(),
        np.concatenate([m_rel, m_rel]),
        np.concatenate([plen_rel, plen_rel]),
        np.concatenate([np.ones(R, np.int32), np.zeros(R, np.int32)]),
        rel_rows_arr,
    ]).astype(np.int32)
    fblob = np.concatenate([
        fF["pe"].ravel(), fF["peob"].ravel(), fF["peoe"].ravel(),
        fF["lf_cb"].ravel(), fF["lf_ce"].ravel(),
        np.concatenate([rb_pe, rev(rb_pe)]).ravel(),
        np.concatenate([lf_ccb, rev(lf_cce)]).ravel(),
        np.concatenate([lf_cce, rev(lf_ccb)]).ravel()])

    meta = (rows, ns, cat, row_flat, col_flat, is_rel, live_n,
            idx_desc, idx_asc, rel_rows_arr, rel_cols)
    return fblob, iblob, (Bn, max_n, 2 * R, max_m), meta
