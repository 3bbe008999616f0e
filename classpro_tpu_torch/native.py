"""ctypes bindings for the C++ host data plane (csrc/host/classpro_host.cpp).

The library is compiled on demand (g++ -O3 -shared) from the package's
own ``classpro_tpu_torch/csrc/host/classpro_host.cpp`` (a copy of the
repository's ``csrc/classpro_host.cpp``, which the JAX package builds,
with ``cp_build_btg``, ``cp_exact_rel_batch``, ``cp_pack_chunk``,
``cp_expand_rows`` and ``cp_demote_reconcile`` added, and its threaded
entries on one worker pool kept for the process) into
``classpro_tpu_torch/_build/``.  The engine has no pure-Python fallback:
a failed build, or a library without one of these entries, raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from classpro_tpu_torch.alldev import blob_sizes
from classpro_tpu_torch.numerics import LOGFACT as _LOGFACT
from classpro_tpu_torch.pack import _bucket, _bucket32

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "host", "classpro_host.cpp")
_BUILD = os.path.join(_HERE, "_build")
_SO = os.path.join(_BUILD, "_classpro_host.so")

_lock = threading.Lock()
_lib = None


_IVDT = np.dtype([
    ("b", "<i4"), ("e", "<i4"), ("cb", "<i4"), ("ce", "<i4"),
    ("ccb", "<i4"), ("cce", "<i4"), ("is_rel", "<i4"), ("pad", "<i4"),
    ("pe", "<f8"), ("pe_o_b", "<f8"), ("pe_o_e", "<f8")])


def _build() -> str:
    src = os.path.abspath(_SRC)
    if not os.path.exists(src):
        raise FileNotFoundError(src)
    os.makedirs(_BUILD, exist_ok=True)
    # build under a private name, then rename: concurrent processes (test
    # workers) never load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-march=native", "-ffp-contract=off", "-pthread",
           "-shared", "-fPIC", "-o", tmp, src, "-lm", "-lz"]
    # libdeflate (~2-3x zlib inflate) when present; plain zlib otherwise
    fast = (cmd[:1] + ["-DCP_HAVE_LIBDEFLATE"] + cmd[1:] + ["-ldeflate"])
    r = subprocess.run(fast, capture_output=True)
    if r.returncode != 0:
        subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _SO)
    return _SO


def get_lib(force: bool = False):
    """The loaded library, built first if missing, older than its source,
    or ``force`` (a fresh build from the checkout, before the first load
    in this process)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if force or not os.path.exists(_SO) or (
                os.path.exists(_SRC)
                and os.path.getmtime(_SRC) > os.path.getmtime(_SO)):
            _build()
        lib = ctypes.CDLL(_SO)
        lib.cp_decode_profile.restype = ctypes.c_int
        lib.cp_decode_profile.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int]
        lib.cp_wall_stage_batch_ptr.restype = None
        lib.cp_wall_stage_batch_ptr.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
            ctypes.c_double, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int]
        lib.cp_pack_rel.restype = None
        lib.cp_pack_rel.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.cp_finish_batch.restype = None
        lib.cp_finish_batch.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, ctypes.c_double,
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.cp_decode_profile_batch.restype = None
        lib.cp_decode_profile_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.cp_gzip_inflate.restype = ctypes.c_int64
        lib.cp_gzip_inflate.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64]
        lib.cp_fastx_parse.restype = ctypes.c_int64
        lib.cp_fastx_parse.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.cp_exact_rel.restype = ctypes.c_int
        lib.cp_exact_rel.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.cp_exact_rel_batch.restype = None
        lib.cp_exact_rel_batch.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_double, ctypes.c_int, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int]
        lib.cp_pack_chunk.restype = ctypes.c_int
        lib.cp_pack_chunk.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int]
        lib.cp_expand_rows.restype = ctypes.c_int
        lib.cp_expand_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.cp_demote_reconcile.restype = ctypes.c_int
        lib.cp_demote_reconcile.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int]
        lib.cp_build_btg.restype = None
        lib.cp_build_btg.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p]
        lib.cp_seed_ws_new.restype = ctypes.c_void_p
        lib.cp_seed_ws_new.argtypes = []
        lib.cp_seed_ws_free.restype = None
        lib.cp_seed_ws_free.argtypes = [ctypes.c_void_p]
        lib.cp_find_seeds.restype = ctypes.c_int
        lib.cp_find_seeds.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int]
        _lib = lib
        return lib


def _threads(threads: int) -> int:
    """The host workers of ``threads`` (-T): <= 0 means min(cpus, 16)."""
    return threads if threads > 0 else min(os.cpu_count() or 1, 16)


def _exact_error(rc: int, where: str = "") -> Exception:
    """The exception of a ``cp_exact_rel`` return code (not 0)."""
    if rc == -3:
        return ValueError(f"{where}more rel records than its rel_out row "
                          f"holds")
    if rc == -2:
        # mirrors the oracle's own failure mode: math.log(0.0)
        # ValueError / int(inf) OverflowError inside the DP
        return ValueError(f"{where}exact rel DP hit log(0)/int(inf) "
                          f"(oracle loud-failure domain)")
    return RuntimeError(f"{where}all DP states impossible at final "
                        f"interval")


# the messages of the all-device feed's return codes (cp_pack_chunk,
# cp_expand_rows)
_FEED_ERRORS = {
    -1: "a record count below 0 where a log-factorial is read",
    -2: "n_rel differs from the read's count of is_rel records",
    -3: "a read does not fit the chunk's dims",
    -4: "K - 1 plus the read's interval lengths do not fill its class line",
    -5: "a record ends before it begins (e < b)"}


def _feed_error(rc: int, err_row, rows) -> ValueError:
    k = int(err_row[0])
    where = (f"packed row {k} (slab read {int(rows[k])}): " if k >= 0
             else "")
    return ValueError(where + _FEED_ERRORS.get(rc, f"error {rc}"))


def _feed_args(slab, slot: int, n_out, rows):
    """The validated slab, n_out (int32) and rows (int32) of a feed call:
    every row a slab read whose records fit its slot."""
    if slab.dtype != _IVDT or not slab.flags.c_contiguous:
        raise ValueError("slab must be a C-contiguous wall slab")
    n_out = np.ascontiguousarray(n_out, np.int32)
    rows = np.ascontiguousarray(rows, np.int32)
    if rows.ndim != 1 or not rows.size:
        raise ValueError("rows must name at least one slab read")
    if rows.min() < 0 or rows.max() >= len(n_out):
        raise IndexError("a row is out of the slab's range")
    if len(slab) < len(n_out) * slot or n_out[rows].min() < 0 \
            or n_out[rows].max() > slot:
        raise ValueError("the slab is shorter than its reads' slots")
    return n_out, rows


def _blob(dest, dtype, n: int, name: str) -> np.ndarray:
    """A packer's blob of ``n`` ``dtype`` elements: fresh (``dest`` None)
    or the first n of ``dest``, which must be a writeable C-contiguous
    numpy array of that dtype with at least n elements (else
    ValueError)."""
    if dest is None:
        return np.empty(n, dtype)
    if not isinstance(dest, np.ndarray) or dest.dtype != dtype \
            or not dest.flags.c_contiguous or not dest.flags.writeable \
            or dest.size < n:
        raise ValueError(f"{name}: want a writeable C-contiguous "
                         f"{np.dtype(dtype).name} array of at least {n} "
                         f"elements")
    return dest.reshape(-1)[:n]


def build_btg(erates, n_cap: int, logfact: np.ndarray) -> np.ndarray:
    """The (len(erates), n_cap, n_cap) binomial-tail table of
    ``tables.build_tables`` in one C++ call (``cp_build_btg``): entry
    [r, n, k] is ``numerics.binom_test_g(k, n, erates[r], False)`` for
    1 <= n < n_cap, k <= n, 0.0 elsewhere; its terms read ``logfact``
    (``numerics.LOGFACT``), as ``tables.btg_plain``, the plain version,
    does."""
    rates = np.ascontiguousarray(erates, np.float64)
    lf = np.ascontiguousarray(logfact, np.float64)
    if lf.shape[0] < n_cap:
        raise ValueError(f"n_cap {n_cap} needs {n_cap} log-factorials, "
                         f"got {lf.shape[0]}")
    out = np.empty((len(rates), n_cap, n_cap), np.float64)
    get_lib().cp_build_btg(rates.ctypes.data, len(rates), n_cap,
                           lf.ctypes.data, out.ctypes.data)
    return out


class NativeSeedWorkspace:
    """C++ seed selection (csrc/host/classpro_host.cpp cp_find_seeds, a port
    of the reference's seed.c): one workspace reused across consecutive
    reads, with the reference's stale-slot semantics (a -T1 worker)."""

    def __init__(self):
        self.lib = get_lib()
        self._ws = self.lib.cp_seed_ws_new()
        self._rep = np.empty(2 * 4096, np.int32)

    def close(self) -> None:
        if self._ws:
            self.lib.cp_seed_ws_free(self._ws)
            self._ws = None

    __del__ = close

    def find_seeds(self, seq: str, classes: str, profile: np.ndarray,
                   K: int) -> tuple[str, list[tuple[int, int]]]:
        """Seed labels of one read (one character per profile position)
        and its repeat intervals [(b, e), ...]; ``classes`` is the read's
        class string from position K-1 on."""
        plen = len(profile)
        if plen <= 0:
            return "", []
        prof = np.ascontiguousarray(profile, np.uint16)
        out = ctypes.create_string_buffer(plen)
        n = self.lib.cp_find_seeds(
            self._ws, seq.encode("ascii"), classes.encode("ascii"),
            prof.ctypes.data, plen, K, out,
            self._rep.ctypes.data, len(self._rep) // 2)
        rints = [(int(self._rep[2 * i]), int(self._rep[2 * i + 1]))
                 for i in range(min(n, len(self._rep) // 2))]
        return out.raw.decode("ascii"), rints


def chunk_dims(n_out, n_rel, rows) -> tuple:
    """The (Bn, max_n, R2, max_m) bucket ``NativeWall.pack_chunk`` packs
    the slab reads ``rows`` at, from their record and reliable-interval
    counts (``pack.pack_chunk``'s dims)."""
    rel = n_rel[rows]
    return (_bucket(len(rows)), _bucket32(int(n_out[rows].max())),
            2 * _bucket(max(int((rel > 0).sum()), 1)),
            _bucket32(max(int(rel.max()), 1)))


class NativeWall:
    """Wall stage (context + walls + reliable intervals), rel packing,
    exact rel oracle and relaxation + expansion, in C++."""

    def __init__(self, gm):
        self.gm = gm
        self.lib = get_lib()
        em = gm.emodel
        d = gm.defaults
        self._pe_thres = np.asarray(
            [d.pe_thres_init_self, d.pe_thres_init_others,
             d.pe_thres_final_self, d.pe_thres_final_others])
        self._lmax = np.asarray(em.lmax, np.int32)
        self._pe = np.ascontiguousarray(em.pe)
        self._cthres = np.ascontiguousarray(em.cthres.astype(np.int16))
        self._lmaxp1 = em.pe.shape[1]
        self._walk_tab = None

    def _walk_tables(self):
        """Bit-exact per-erate binomial tail tables for the wall walk
        (tables.py; cached on the GlobalModel)."""
        if self._walk_tab is None:
            from classpro_tpu_torch.tables import build_tables

            dt = build_tables(self.gm)
            self._walk_tab = (np.ascontiguousarray(dt.btg),
                              np.ascontiguousarray(dt.erates),
                              np.ascontiguousarray(dt.pe_idx, np.int32)
                              if dt.pe_idx.dtype != np.int32 else
                              np.ascontiguousarray(dt.pe_idx),
                              int(dt.hc_idx), int(dt.n_cap))
        return self._walk_tab

    def wall_stage_slab(self, seqs: list[bytes],
                        profiles: list[np.ndarray],
                        threads: int = 0, slot: int = 1024):
        """Multithreaded wall stage returning the raw slotted slab
        (read i's records at rows [i*slot, i*slot+n_out[i])) for zero-copy
        consumption by `pack_rel`/`finish_batch`.  Returns
        (slab structured array, n_out, n_rel, slot); retries the whole
        batch with a larger slot on overflow (rare)."""
        gm = self.gm
        n = len(seqs)
        threads = _threads(threads)
        # pointer arrays into the caller-owned buffers (no concatenation)
        profs_c = [np.ascontiguousarray(p, np.uint16) for p in profiles]
        seq_ptrs = (ctypes.c_char_p * n)(*seqs)
        prof_ptrs = (ctypes.c_void_p * n)(
            *[p.ctypes.data for p in profs_c])
        seq_len = np.array([len(s) for s in seqs], np.int32)
        prof_len = np.array([len(p) for p in profs_c], np.int32)
        while True:
            # np.empty + pooling: the C++ fills [i*slot, i*slot+n_out[i])
            # and every consumer masks to n_out, so neither zeroing nor a
            # fresh 11MB allocation (page faults) per chunk is needed —
            # slabs are recycled via release_slab() at finish
            out = None
            pool = getattr(self, "_slab_pool", None)
            if pool:
                for k, buf in enumerate(pool):
                    if buf.shape[0] >= n * slot:
                        out = pool.pop(k)[: n * slot]
                        break
            if out is None:
                out = np.empty(n * slot, dtype=_IVDT)
            n_out = np.zeros(n, np.int32)
            n_rel = np.zeros(n, np.int32)
            btg, erates, pe_idx, hc_idx, n_cap = self._walk_tables()
            self.lib.cp_wall_stage_batch_ptr(
                gm.kmer, gm.cmax, int(gm.cov[2]), gm.read_len,
                gm.defaults.max_n_hc, gm.defaults.min_cnt_change,
                gm.defaults.max_cnt_change,
                self._pe_thres.ctypes.data, gm.defaults.thres_diff_eo,
                gm.defaults.thres_diff_rel, gm.emodel.hc_erate,
                self._lmax.ctypes.data, self._lmaxp1,
                self._pe.ctypes.data, self._cthres.ctypes.data,
                btg.ctypes.data, erates.ctypes.data, pe_idx.ctypes.data,
                hc_idx, n_cap,
                n, seq_ptrs, seq_len.ctypes.data,
                prof_ptrs, prof_len.ctypes.data,
                out.ctypes.data_as(ctypes.c_void_p), slot,
                n_out.ctypes.data, n_rel.ctypes.data, threads)
            if (n_out >= 0).all():
                return out, n_out, n_rel, slot
            slot *= 4

    def release_slab(self, slab: np.ndarray) -> None:
        """Return a wall slab for reuse (keeps at most 4 — the stream
        holds <= 3 chunks in flight)."""
        pool = getattr(self, "_slab_pool", None)
        if pool is None:
            pool = self._slab_pool = []
        base = slab.base if slab.base is not None else slab
        if len(pool) < 4:
            pool.append(base)

    def pack_rel(self, slab: np.ndarray, slot: int, n_out: np.ndarray,
                 n_rel: np.ndarray, plens: np.ndarray, R: int,
                 max_m: int, fblob=None,
                 iblob=None) -> tuple[np.ndarray, np.ndarray]:
        """Fill the rel-only transfer blobs from a wall slab (layout:
        rel_only_dev docstring) in one native call: fresh arrays, or the
        given destinations (``_blob``; the entry writes every element, so
        what they held does not matter)."""
        fblob = _blob(fblob, np.float64, R * max_m, "fblob")
        iblob = _blob(iblob, np.int32, 4 * R * max_m + 2 * R, "iblob")
        self.lib.cp_pack_rel(
            len(n_out), slab.ctypes.data_as(ctypes.c_void_p), slot,
            n_out.ctypes.data, n_rel.ctypes.data,
            np.ascontiguousarray(plens, np.int64).ctypes.data, R, max_m,
            iblob.ctypes.data, fblob.ctypes.data)
        return fblob, iblob

    def _exact_globals(self) -> tuple:
        """The model arguments of ``cp_exact_rel`` and its batch."""
        gm = self.gm
        d = gm.defaults
        return (int(gm.cov[0]), int(gm.cov[1]), int(gm.cov[2]),
                int(gm.cov[3]), float(gm.dr_ratio), gm.read_len, d.r_logp,
                d.e_po_base, d.pe_mean, d.offset)

    def exact_rel(self, rels: np.ndarray, plen: int) -> np.ndarray:
        """Exact fw/bw reliable-interval classification (C++ port of the
        Python oracle exact/rel.py) for ONE read; ``rels`` is a
        structured _IVDT array holding its rel interval records only.
        The plain version of ``exact_rel_batch`` (tests, chip_smoke)."""
        M = len(rels)
        out = np.empty(M, np.int8)
        if M == 0:
            return out
        rels = np.ascontiguousarray(rels)
        r = self.lib.cp_exact_rel(
            *self._exact_globals(), rels.ctypes.data_as(ctypes.c_void_p),
            M, int(plen), out.ctypes.data_as(ctypes.c_void_p))
        if r != 0:
            raise _exact_error(r)
        return out

    def exact_rel_batch(self, slab: np.ndarray, slot: int,
                        n_out: np.ndarray, reads, plens, rel_out: np.ndarray,
                        rows, threads: int = 0) -> None:
        """The exactness guard's re-decisions of one chunk in one threaded
        C++ call (``cp_exact_rel_batch``): for each k, the rel records of
        slab read ``reads[k]`` (profile length ``plens[k]``) re-decided as
        ``exact_rel`` does, into ``rel_out[rows[k], :m]`` in place (m its
        rel count; rel_out a C-contiguous int8 (R, max_m) array).  The
        bytes do not depend on ``threads`` (<= 0: min(cpus, 16)).  Raises
        what ``exact_rel`` raises, for the first failing k."""
        reads = np.ascontiguousarray(reads, np.int32)
        plens = np.ascontiguousarray(plens, np.int64)
        rows = np.ascontiguousarray(rows, np.int32)
        n = len(reads)
        if len(plens) != n or len(rows) != n:
            raise ValueError("reads, plens and rows differ in length")
        if rel_out.dtype != np.int8 or rel_out.ndim != 2 \
                or not rel_out.flags.c_contiguous:
            raise ValueError("rel_out must be a C-contiguous int8 matrix")
        if slab.dtype != _IVDT or not slab.flags.c_contiguous:
            raise ValueError("slab must be a C-contiguous wall slab")
        if n == 0:
            return
        n_out = np.ascontiguousarray(n_out, np.int32)
        if reads.min() < 0 or reads.max() >= len(n_out) \
                or rows.min() < 0 or rows.max() >= rel_out.shape[0]:
            raise IndexError("a read or row index is out of range")
        if len(slab) < len(n_out) * slot or n_out[reads].max() > slot:
            raise ValueError("the slab is shorter than its reads' slots")
        rc = np.zeros(n, np.int32)
        self.lib.cp_exact_rel_batch(
            *self._exact_globals(), slab.ctypes.data_as(ctypes.c_void_p),
            slot, n_out.ctypes.data, n, reads.ctypes.data, plens.ctypes.data,
            rows.ctypes.data, rel_out.ctypes.data, rel_out.shape[1],
            rc.ctypes.data, _threads(threads))
        bad = np.flatnonzero(rc)
        if bad.size:
            k = int(bad[0])
            raise _exact_error(int(rc[k]), f"read {int(reads[k])} (batch "
                                           f"row {k}): ")

    def pack_chunk(self, slab: np.ndarray, slot: int, n_out, n_rel, plens,
                   rows, threads: int = 0, fblob=None, iblob=None):
        """The all-device transfer blobs of the slab reads ``rows`` (in
        the order they are packed; the engine packs those with records)
        in one threaded C++ call (``cp_pack_chunk``); ``plens`` is indexed
        by slab read.  The layout, bytes and dims of ``pack.pack_chunk``, its
        plain version, whatever ``threads`` (<= 0: min(cpus, 16)), into
        fresh arrays or the given destinations (``_blob``; every element
        is written, padding included).
        Returns (fblob, iblob, (Bn, max_n, R2, max_m)); raises ValueError
        for a negative count where a log-factorial is read and for an
        ``n_rel`` that differs from the read's is_rel records."""
        n_out, rows = _feed_args(slab, slot, n_out, rows)
        n_rel = np.ascontiguousarray(n_rel, np.int32)
        plens = np.ascontiguousarray(plens, np.int64)
        if len(n_rel) != len(n_out) or len(plens) != len(n_out):
            raise ValueError("n_out, n_rel and plens differ in length")
        dims = chunk_dims(n_out, n_rel, rows)
        Bn, max_n, R, max_m = dims[0], dims[1], dims[2] // 2, dims[3]
        n_f, n_i = blob_sizes(*dims)
        fblob = _blob(fblob, np.float64, n_f, "fblob")
        iblob = _blob(iblob, np.int32, n_i, "iblob")
        err = np.zeros(1, np.int32)
        rc = self.lib.cp_pack_chunk(
            slab.ctypes.data_as(ctypes.c_void_p), slot, n_out.ctypes.data,
            n_rel.ctypes.data, plens.ctypes.data, rows.ctypes.data,
            len(rows), Bn, max_n, R, max_m, _LOGFACT.ctypes.data,
            len(_LOGFACT), iblob.ctypes.data, fblob.ctypes.data,
            err.ctypes.data, _threads(threads))
        if rc:
            raise _feed_error(rc, err, rows)
        return fblob, iblob, dims

    def expand_rows(self, slab: np.ndarray, slot: int, n_out, rows,
                    asgn: np.ndarray, out_off: np.ndarray,
                    threads: int = 0) -> np.ndarray:
        """The class lines of the slab reads ``rows`` in one threaded C++
        call (``cp_expand_rows``): read ``rows[r]``'s line, at
        ``out_off[r]``, is K - 1 'N' and then each record's e - b bytes of
        "ERHD"[clip(asgn[r, column], 0, 3)], as ``pack.expand_asgn``, its
        plain version, writes it.  ``asgn`` is a 1-byte matrix with
        unit column stride (the all-device result's assignment columns).
        Returns the uint8 buffer of ``out_off[-1]`` bytes; raises
        ValueError when a line's length is not K - 1 plus its records'."""
        n_out, rows = _feed_args(slab, slot, n_out, rows)
        out_off = np.ascontiguousarray(out_off, np.int64)
        if asgn.itemsize != 1 or asgn.ndim != 2 or asgn.strides[1] != 1 \
                or asgn.shape[0] < len(rows) \
                or asgn.shape[1] < n_out[rows].max():
            raise ValueError("asgn must be a 1-byte matrix with unit column "
                             "stride, a row per read and a column per "
                             "record")
        if len(out_off) != len(rows) + 1 or out_off[0] != 0 \
                or (np.diff(out_off) < 0).any():
            raise ValueError("out_off must rise from 0 over the rows")
        buf = np.empty(int(out_off[-1]), np.uint8)
        err = np.zeros(1, np.int32)
        rc = self.lib.cp_expand_rows(
            slab.ctypes.data_as(ctypes.c_void_p), slot, n_out.ctypes.data,
            rows.ctypes.data, len(rows), asgn.ctypes.data, asgn.strides[0],
            self.gm.kmer, out_off.ctypes.data, buf.ctypes.data,
            err.ctypes.data, _threads(threads))
        if rc:
            raise _feed_error(rc, err, rows)
        return buf

    def demote_reconcile(self, v: np.ndarray, rescue, b, e, ccb, cce, m,
                         gH: int, gD: int, threads: int = 0) -> np.ndarray:
        """The main path's host rel steps after the DP in one threaded C++
        call (``cp_demote_reconcile``): the (R, max_m) int8 forward-order
        assignment that ``rel.reconcile_fwbw(rel.demote_host(v, rescue,
        b, e, ccb, cce, m, gH, gD), ccb, cce, m)``, its plain version,
        returns, byte for byte, padding columns included, whatever
        ``threads`` (<= 0: min(cpus, 16); a worker per 256 read pairs, at
        most that many).  ``v`` is the DP's (2R, max_m) 1-byte assignment
        matrix with unit column stride (fw rows, then bw rows in scan
        order; any row stride), ``rescue`` its (2R,) no-H rescue flags,
        b/e/ccb/cce the (R, max_m) forward-order planes and ``m`` the
        (R,) live counts.  Raises ValueError for an ``m`` below 0 or
        above max_m."""
        R, max_m = np.shape(b)
        if v.itemsize != 1 or v.ndim != 2 or v.shape != (2 * R, max_m) \
                or v.strides[1] != 1:
            raise ValueError("v must be a (2R, max_m) 1-byte matrix with "
                             "unit column stride")
        planes = [np.ascontiguousarray(x, np.int32) for x in (b, e, ccb, cce)]
        if any(x.shape != (R, max_m) for x in planes):
            raise ValueError("b, e, ccb and cce must be (R, max_m)")
        m = np.ascontiguousarray(m, np.int32)
        rescue = np.ascontiguousarray(rescue, np.bool_)
        if m.shape != (R,) or rescue.shape != (2 * R,):
            raise ValueError("m must hold R counts and rescue 2R flags")
        out = np.empty((R, max_m), np.int8)
        err = np.zeros(1, np.int32)
        rc = self.lib.cp_demote_reconcile(
            v.ctypes.data, v.strides[0], rescue.ctypes.data,
            *[x.ctypes.data for x in planes], m.ctypes.data, R, max_m,
            int(gH), int(gD), out.ctypes.data, err.ctypes.data,
            _threads(threads))
        if rc:
            j = int(err[0])
            raise ValueError(f"rel row {j}: m {int(m[j])} is outside "
                             f"[0, max_m {max_m}]")
        return out

    def finish_batch(self, slab: np.ndarray, slot: int, n_out: np.ndarray,
                     n_rel: np.ndarray, rel_out, max_m: int,
                     out_off: np.ndarray, threads: int = 0) -> np.ndarray:
        """Scatter device rel assignments + relaxation sweeps + class
        expansion, one threaded native call.  rel_out may be None when
        no read had reliable intervals."""
        gm = self.gm
        d = gm.defaults
        threads = _threads(threads)
        if not hasattr(self, "_sk"):
            from classpro_tpu_torch.skellam import build_skellam_tables
            from classpro_tpu_torch.tables import build_tables

            st = build_skellam_tables()
            dt = build_tables(gm)
            self._sk = (np.ascontiguousarray(st.table_a),
                        np.ascontiguousarray(st.table_b),
                        np.ascontiguousarray(dt.btg_log()[dt.unrel_idx]),
                        dt.n_cap)
        buf = np.empty(int(out_off[-1]), np.uint8)
        rel_ptr = (rel_out.ctypes.data_as(ctypes.c_void_p)
                   if rel_out is not None else None)
        # CP_EXACT_SK=1: run the relaxation with exact Bessel terms
        # everywhere (null Skellam tables) — a self-consistency check
        # of the exactness guard: outputs must match the table path
        # byte for byte (tests/tools use it; production keeps tables)
        sk_a = (None if os.environ.get("CP_EXACT_SK")
                else self._sk[0].ctypes.data)
        sk_b = (None if os.environ.get("CP_EXACT_SK")
                else self._sk[1].ctypes.data)
        self.lib.cp_finish_batch(
            int(gm.cov[0]), int(gm.cov[1]), int(gm.cov[2]), int(gm.cov[3]),
            float(gm.dr_ratio), gm.read_len, d.r_logp, d.e_po_base,
            d.pe_mean,
            sk_a, sk_b,
            self._sk[2].ctypes.data, self._sk[3],
            len(n_out), slab.ctypes.data_as(ctypes.c_void_p), slot,
            n_out.ctypes.data, n_rel.ctypes.data, rel_ptr, max_m,
            gm.kmer, out_off.ctypes.data, buf.ctypes.data, threads)
        return buf
