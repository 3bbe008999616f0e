"""ctypes bindings for the C++ host data plane (csrc/classpro_host.cpp).

The library is compiled on demand (g++ -O3 -shared) from the repository's
``csrc/classpro_host.cpp`` into ``classpro_tpu_torch/_build/``.  The
engine has no pure-Python fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "csrc", "classpro_host.cpp")
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


class NativeSeedWorkspace:
    """C++ seed selection (csrc/classpro_host.cpp cp_find_seeds, a port
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
        import os as _os

        gm = self.gm
        n = len(seqs)
        if threads <= 0:
            threads = min(_os.cpu_count() or 1, 16)
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
                 max_m: int) -> tuple[np.ndarray, np.ndarray]:
        """Fill the rel-only transfer blobs from a wall slab (layout:
        rel_only_dev docstring) in one native call."""
        iblob = np.empty(4 * R * max_m + 2 * R, np.int32)
        fblob = np.empty(R * max_m, np.float64)
        self.lib.cp_pack_rel(
            len(n_out), slab.ctypes.data_as(ctypes.c_void_p), slot,
            n_out.ctypes.data, n_rel.ctypes.data,
            np.ascontiguousarray(plens, np.int64).ctypes.data, R, max_m,
            iblob.ctypes.data, fblob.ctypes.data)
        return fblob, iblob

    def exact_rel(self, rels: np.ndarray, plen: int) -> np.ndarray:
        """Exact fw/bw reliable-interval classification (C++ port of the
        Python oracle exact/rel.py) for ONE read; ``rels`` is a
        structured _IVDT array holding its rel interval records only.
        Used by the engine's exactness guard (engine._exact_guard)."""
        gm = self.gm
        d = gm.defaults
        M = len(rels)
        out = np.empty(M, np.int8)
        if M == 0:
            return out
        rels = np.ascontiguousarray(rels)
        r = self.lib.cp_exact_rel(
            int(gm.cov[0]), int(gm.cov[1]), int(gm.cov[2]), int(gm.cov[3]),
            float(gm.dr_ratio), gm.read_len, d.r_logp, d.e_po_base,
            d.pe_mean, d.offset,
            rels.ctypes.data_as(ctypes.c_void_p), M, int(plen),
            out.ctypes.data_as(ctypes.c_void_p))
        if r == -2:
            # mirrors the oracle's own failure mode: math.log(0.0)
            # ValueError / int(inf) OverflowError inside the DP
            raise ValueError("exact rel DP hit log(0)/int(inf) "
                             "(oracle loud-failure domain)")
        if r != 0:
            raise RuntimeError("all DP states impossible at final interval")
        return out

    def finish_batch(self, slab: np.ndarray, slot: int, n_out: np.ndarray,
                     n_rel: np.ndarray, rel_out, max_m: int,
                     out_off: np.ndarray, threads: int = 0) -> np.ndarray:
        """Scatter device rel assignments + relaxation sweeps + class
        expansion, one threaded native call.  rel_out may be None when
        no read had reliable intervals."""
        import os as _os

        gm = self.gm
        d = gm.defaults
        if threads <= 0:
            threads = min(_os.cpu_count() or 1, 16)
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
        sk_a = (None if _os.environ.get("CP_EXACT_SK")
                else self._sk[0].ctypes.data)
        sk_b = (None if _os.environ.get("CP_EXACT_SK")
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
