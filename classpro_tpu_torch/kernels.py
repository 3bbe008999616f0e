"""Build and bind the hand-written CUDA kernels (csrc/).

``rel_dp`` (csrc/rel_dp.cu: the reliable-interval DP; ``rel_dp_first``
launches it with its prologue, the planes from the chunk's blobs, and its
row tails, the no-H rescue predicate and the packed result;
``rel_dp_rescue`` with the rescue tail, ``rel_dp_pack`` with the pack
tail), ``unrel_sweeps`` (csrc/unrel.cu: the two relaxation sweeps,
with ``gate`` its gate tail: the rows packed with the reads' guard
flags) and
the all-device path's per-chunk glue around them (csrc/glue.cu:
``rel_prep``, ``rel_settle``) are the wrappers the paths call: on CUDA
tensors they launch the sm_90a kernel on the current stream and count
the launch in ``LAUNCHES``; on CPU tensors they run the plain torch
version (rel_ref, unrel_ref, rel.prep_ref / rescue_rows / pack_out /
pack_ref, alldev.prep_ref / settle_ref / gate_ref).  There is no
fallback between the two: a failed nvcc build or a refused launch
raises.  The launches need no host sync and allocate only through torch,
so a CUDA graph can capture them (rel.ChunkGraph, alldev.BatchGraph).

Each kernel is compiled at first use with nvcc into ``_build/`` (plain C
interface, loaded with ctypes), never at import.  The ``*_host`` functions
run the same bodies compiled by g++ (the headers under -x c++, a warp's
32 lanes phase by phase); they are the CPU tests' window onto the
kernels' arithmetic and lane exchanges and never run on a path.
"""

from __future__ import annotations

import ctypes
import functools
import math
import os
import subprocess
import threading

import torch

from classpro_tpu_torch.constants import REL_MARGIN_EPS
from classpro_tpu_torch.params import RelParams, UnrelParams

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")
# kernel -> (source, headers it includes)
SOURCES = {
    "rel_dp": ("rel_dp.cu", ("rel_dp_row.cuh", "prep_cell.cuh",
                             "rel_tail.cuh", "rd_math.cuh",
                             "warp_lanes.cuh")),
    "unrel_sweeps": ("unrel.cu", ("unrel_row.cuh", "rd_math.cuh",
                                  "warp_lanes.cuh")),
}
# the two glue kernels share one source and one library
_GLUE = ("glue.cu", ("glue_row.cuh", "prep_cell.cuh", "rel_tail.cuh",
                     "rd_math.cuh", "warp_lanes.cuh"))
GLUE_KERNELS = ("rel_prep", "rel_settle")
SOURCES.update({name: _GLUE for name in GLUE_KERNELS})

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]
HOST_FLAGS = ["-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
              "-x", "c++"]

# launches of the CUDA kernels (plain-version calls on the CPU do not count)
LAUNCHES = {name: 0 for name in SOURCES}
# of LAUNCHES["rel_dp"], those that ran the DP kernel's first-pass
# prologue (the main layout's planes, once rel_prep's), its rescue tail
# and its pack tail (rel_tail.cuh); of LAUNCHES["unrel_sweeps"], those
# that ran the sweep kernel's gate tail (unrel_row.cuh)
TAIL_LAUNCHES = {"prologue": 0, "rel_rescue": 0, "rel_pack": 0, "gate": 0}
# compiler output of the last build in this process, by (kernel, kind)
# (nvcc's -Xptxas -v lines)
BUILD_LOG: dict = {}

_lock = threading.Lock()
_libs: dict = {}

_PTR = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_LL = ctypes.c_longlong
# C argument lists: rel_dp.cu RD_ARGS_DECL, unrel.cu UR_ARGS_DECL
_ARGTYPES = {
    "rel_dp": ([_PTR] * 25 + [_D, _I, _I, _PTR, _PTR, _I, _D, _LL]
               + [_D] * 4),
    "unrel_sweeps": ([_PTR] * 13 + [_I, _I, _PTR, _PTR, _I, _PTR, _I]
                     + [_D] * 5 + [_LL] * 3),
}
# glue.cu GP_ARGS_DECL, GS_ARGS_DECL
_ARGTYPES.update({
    "rel_prep": [_PTR] * 4 + [_D] + [_I] * 4 + [_D] * 2 + [_PTR] * 17,
    "rel_settle": [_PTR] * 14 + [_I] * 4 + [_PTR, _PTR],
})
_ENTRY = {("rel_dp", "cuda"): "rel_dp_launch", ("rel_dp", "host"): "rel_dp_host",
          ("unrel_sweeps", "cuda"): "unrel_launch",
          ("unrel_sweeps", "host"): "unrel_host"}
_ENTRY.update({(name, kind): f"{name}_{'launch' if kind == 'cuda' else kind}"
               for name in GLUE_KERNELS for kind in ("cuda", "host")})


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def _stale(so: str, name: str) -> bool:
    src, hdrs = SOURCES[name]
    deps = [os.path.join(_CSRC, f) for f in (src,) + hdrs]
    return not os.path.exists(so) or any(
        os.path.getmtime(d) > os.path.getmtime(so) for d in deps)


def _compile(cmd: list, so: str, key) -> None:
    """Run one compiler command into a private name, then rename (test
    workers never load a half-written library); raise on failure."""
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    r = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True)
    BUILD_LOG[key] = r.stdout + r.stderr
    if r.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed building {so}:\n"
                           f"{BUILD_LOG[key]}")
    os.replace(tmp, so)


def build(kind: str = "cuda", name: str = "rel_dp", force: bool = False,
          clocks: bool = False) -> str:
    """Compile kernel ``name`` (``cuda``: nvcc for sm_90a) or its host
    test shim (``host``: g++) if its sources changed; returns the .so
    path.  ``clocks`` builds the DP kernel with -DRD_PHASE_CLOCKS (its
    per-phase clock sums, rel_dp_row.cuh) into a library of its own,
    which no path loads (chip_smoke.py --phases k1profile reads it)."""
    src = os.path.join(_CSRC, SOURCES[name][0])
    stem = os.path.splitext(SOURCES[name][0])[0]
    flags = ["-DRD_PHASE_CLOCKS"] if clocks else []
    if kind == "cuda":
        cmd = [_nvcc()] + NVCC_FLAGS + flags + ["-I", _CSRC, src]
    elif kind == "host":
        cmd = ["g++"] + HOST_FLAGS + flags + ["-I", _CSRC, src]
    else:
        raise ValueError(kind)
    tag = "_clocks" if clocks else ""
    so = os.path.join(_BUILD, f"lib{stem}_{kind}{tag}.so")
    if force or _stale(so, name):
        _compile(cmd, so, (name, kind + tag))
        for other, (osrc, _) in SOURCES.items():   # the same library
            if osrc == SOURCES[name][0]:
                BUILD_LOG[(other, kind + tag)] = BUILD_LOG[(name, kind + tag)]
    return so


def _entry(name: str, kind: str, entry: str, argtypes: list):
    """The loaded C function ``entry`` of kernel ``name``'s library
    (built first)."""
    with _lock:
        fn = _libs.get((name, kind, entry))
        if fn is None:
            fn = getattr(ctypes.CDLL(build(kind, name)), entry)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
            _libs[(name, kind, entry)] = fn
        return fn


def _fn(name: str, kind: str):
    """The loaded launch (``cuda``) or shim (``host``) entry of kernel
    ``name``."""
    return _entry(name, kind, _ENTRY[(name, kind)],
                  _ARGTYPES[name] + ([_PTR] if kind == "cuda" else []))


_GEO_KEYS = ("lanes_per_row", "rows_per_warp", "threads_per_block",
             "blocks", "smem_bytes")


def rel_dp_geometry(R2: int, max_m: int, kind: str = "cuda") -> dict:
    """The DP kernel's launch geometry for (R2, max_m), as rel_dp.cu
    computes it: lanes per row, rows per warp, threads per block, blocks
    and shared bytes per block (0 when the backpointers use the global
    scratch)."""
    out = (ctypes.c_int * 5)()
    _entry("rel_dp", kind, "rel_dp_geometry", [_I, _I, _PTR])(
        R2, max_m, ctypes.cast(out, _PTR))
    return dict(zip(_GEO_KEYS, list(out)))


def unrel_geometry(B: int, N: int, kind: str = "cuda") -> dict:
    """The sweep kernel's launch geometry for (B, N), as unrel.cu computes
    it: lanes per row, rows per warp, threads per block, blocks, shared
    bytes per block (0 when the rows' state uses the global scratch) and
    the bytes of one row's state."""
    out = (ctypes.c_longlong * 6)()
    _entry("unrel_sweeps", kind, "unrel_geometry", [_I, _I, _PTR])(
        B, N, ctypes.cast(out, _PTR))
    return dict(zip(_GEO_KEYS + ("row_bytes",), list(out)))


def _launch(name: str, device, args) -> None:
    """Launch kernel ``name`` on the current stream of ``device``; raise
    if the launch was refused, count it otherwise."""
    fn = _fn(name, "cuda")
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    LAUNCHES[name] += 1


def _check(planes, cov, active, device):
    """Device, dtype, shape and contiguity checks of the kernel inputs."""
    bpos = planes[0]
    if bpos.dim() != 2:
        raise ValueError("bpos must be (R2, max_m)")
    R2, M = bpos.shape
    want = ([torch.int64] * 5 + [torch.float64] * 2
            + [torch.int64, torch.int64, torch.bool])
    names = ("bpos", "bcnt", "epos", "ecnt", "max_cc", "lf_bcnt", "logpE",
             "m", "plen", "fwd")
    for name, t, dt in zip(names, planes, want):
        shape = (R2, M) if name not in ("m", "plen", "fwd") else (R2,)
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    extra = [("cov", cov, torch.int64, (R2, 4))]
    if active is not None:
        extra.append(("active", active, torch.bool, (R2,)))
    for name, t, dt, shape in extra:
        if t.dtype != dt or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dt} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    for t in list(planes) + [cov] + ([active] if active is not None else []):
        if t.device != device:
            raise ValueError(f"tensor on {t.device}, kernel on {device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if M < 1:
        raise ValueError("max_m must be >= 1")
    return R2, M


@functools.lru_cache(maxsize=None)
def _needs_scratch(max_m: int) -> bool:
    """Whether a DP block's backpointers and only_r flags at ``max_m``
    overflow its shared memory into the global scratch (the card's
    choice, rel_dp_geometry)."""
    return rel_dp_geometry(1, max_m, "cuda")["smem_bytes"] == 0


def _ptr(t):
    return t.data_ptr() if t is not None else None


def _args(planes, cov, P: RelParams, active, R2, M, kind="cuda",
          tail=(None,) * 5, blobs=None):
    """Outputs, scratch and the flat C argument list (RD_ARGS_DECL).  The
    global backpointer scratch is allocated only where the card needs it
    (``_needs_scratch``); the host shim always takes it.  ``tail``: the
    row tails' (rescue, cov2, gcov, packed, mm_prev), None where a tail
    does not run.  ``blobs``: (iblob, fblob) of the main layout, from
    which the prologue writes ``planes`` and ``cov`` (with P.logfact and
    P.e_po_base), or None."""
    dev = planes[0].device
    asgn = torch.empty((R2, M), dtype=torch.int8, device=dev)
    dp = torch.empty((R2, 4), dtype=torch.float64, device=dev)
    mm = torch.empty((R2,), dtype=torch.float64, device=dev)
    bp = rpos = None
    if kind == "host" or _needs_scratch(M):
        bp = torch.empty((R2, max(M - 1, 1), 4), dtype=torch.int8,
                         device=dev)
        rpos = torch.empty((R2, M), dtype=torch.uint8, device=dev)
    if P.tab.device != dev or P.lf_small.device != dev:
        raise ValueError("RelParams must live on the kernel's device")
    if P.tab.dtype != torch.float64 or not P.tab.is_contiguous():
        raise ValueError("packed table must be contiguous f64")
    iblob, fblob = blobs or (None, None)
    args = ([t.data_ptr() for t in planes] + [cov.data_ptr(), _ptr(active)]
            + [_ptr(t) for t in (asgn, dp, mm, bp, rpos) + tuple(tail)]
            + [_ptr(iblob), _ptr(fblob),
               _ptr(P.logfact) if blobs else None, float(P.e_po_base)]
            + [R2, M, P.tab.data_ptr(), P.lf_small.data_ptr(),
               int(P.lf_small.shape[0]), float(P.read_len), int(P.offset),
               float(P.r_logp), float(P.log_1m_pe_mean),
               float(P.log_pe_mean), float(P.dr_ratio)])
    keep = (asgn, dp, mm, bp, rpos)
    return args, keep


def _dp_run(kind, planes, cov, P: RelParams, active=None,
            tail=(None,) * 5, blobs=None):
    """Check the DP's inputs, then launch the kernel (``cuda``) or run its
    shim (``host``) with the row tails' ``tail`` and the prologue's
    ``blobs`` (as ``_args``); returns the pass's (asgn, dp, margin)."""
    if kind == "host":
        planes = tuple(t.contiguous() for t in planes)
        cov = cov.contiguous()
    dev = planes[0].device
    R2, M = _check(planes, cov, active, dev)
    args, keep = _args(planes, cov, P, active, R2, M, kind, tail, blobs)
    if kind == "cuda":
        _launch("rel_dp", dev, args)
        TAIL_LAUNCHES["prologue"] += blobs is not None
        TAIL_LAUNCHES["rel_rescue"] += tail[0] is not None
        TAIL_LAUNCHES["rel_pack"] += tail[3] is not None
    elif _fn("rel_dp", "host")(*args) != 0:
        raise RuntimeError("host shim failed")
    return keep[:3]


def _plain_dp(planes, cov, P: RelParams):
    from classpro_tpu_torch.rel_ref import rel_dp_ref

    return rel_dp_ref(*planes, cov, P)


def _need_cuda(t) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")


def rel_dp(bpos, bcnt, epos, ecnt, max_cc, lf_bcnt, logpE, m, plen, fwd,
           cov, P: RelParams, active=None):
    """One merged-direction DP pass (rel_ref.rel_dp_ref's contract; the
    kernel replaces rel_dev2.rel_dp_pass2, rel_dev2.py:636-787):
    returns (asgn int8 (R2, max_m), dp f64 (R2, 4), margin f64 (R2,)).
    ``active`` (bool (R2,)) limits the pass to those rows; the others'
    outputs are left unwritten.  CUDA tensors launch the kernel on the
    current stream; CPU tensors run the plain torch version."""
    planes = (bpos, bcnt, epos, ecnt, max_cc, lf_bcnt, logpE, m, plen, fwd)
    if bpos.device.type == "cpu":
        return _plain_dp(planes, cov, P)
    _need_cuda(bpos)
    return _dp_run("cuda", planes, cov, P, active)


def rel_dp_host(bpos, bcnt, epos, ecnt, max_cc, lf_bcnt, logpE, m, plen,
                fwd, cov, P: RelParams, active=None):
    """The kernel's warp body compiled by g++ and run on CPU tensors, a
    warp's 32 lanes phase by phase (test-only; same contract as
    ``rel_dp``)."""
    return _dp_run("host", (bpos, bcnt, epos, ecnt, max_cc, lf_bcnt, logpE,
                            m, plen, fwd), cov, P, active)


def _rescue_tail(planes, P: RelParams, pack: bool):
    """The rescue tail's outputs (rescue, cov2) and, with ``pack``, the
    pack tail's (packed), allocated; the tail argument of ``_dp_run``."""
    R2, M = planes[0].shape
    dev = planes[0].device
    _need("gcov", P.gcov, torch.int64, (4,), dev)
    rescue = torch.empty(R2, dtype=torch.bool, device=dev)
    cov2 = torch.empty((R2, 4), dtype=torch.int64, device=dev)
    packed = (torch.empty((R2, M + 5), dtype=torch.uint8, device=dev)
              if pack else None)
    return (rescue, cov2, P.gcov, packed, None)


def _rescue_run(kind, planes, cov, P: RelParams):
    tail = _rescue_tail(planes, P, pack=False)
    return _dp_run(kind, planes, cov, P, tail=tail) + tail[:2]


def rel_dp_rescue(bpos, bcnt, epos, ecnt, max_cc, lf_bcnt, logpE, m, plen,
                  fwd, cov, P: RelParams):
    """The first DP pass with its rescue tail (the tail replaces
    device_pipeline._rel_pipeline's no-H rescue predicate, :198-234), the
    all-device path's first pass: returns (asgn, dp, margin as rel_dp,
    rescue bool (R2,), the rescue pass's coverages int64 (R2, 4)).  CUDA
    tensors launch the kernel (one launch); CPU tensors run the plain
    versions (rel_ref, rel.rescue_rows)."""
    planes = (bpos, bcnt, epos, ecnt, max_cc, lf_bcnt, logpE, m, plen, fwd)
    if bpos.device.type == "cpu":
        from classpro_tpu_torch.rel import rescue_rows

        a, d, mm = _plain_dp(planes, cov, P)
        return (a, d, mm) + rescue_rows(planes, a, P, a.shape[1])
    _need_cuda(bpos)
    return _rescue_run("cuda", planes, cov, P)


def rel_dp_rescue_host(bpos, bcnt, epos, ecnt, max_cc, lf_bcnt, logpE, m,
                       plen, fwd, cov, P: RelParams):
    """rel_dp_rescue's kernel body with its rescue tail compiled by g++
    (test-only; same contract)."""
    return _rescue_run("host", (bpos, bcnt, epos, ecnt, max_cc, lf_bcnt,
                                logpE, m, plen, fwd), cov, P)


def _main_planes(fblob, iblob, P: RelParams, R: int, max_m: int):
    """Checks of a main-layout chunk's blobs; the planes and coverages the
    first pass's prologue writes, allocated (kernels.rel_dp's inputs)."""
    dev = iblob.device
    R2, M = 2 * R, max_m
    _need("iblob", iblob, torch.int32, (4 * R * M + 2 * R,), dev)
    _need("fblob", fblob, torch.float64, (R * M,), dev)
    # the prologue clamps its counts into the 32768-entry table
    _need("logfact", P.logfact, torch.float64, (32768,), dev)
    rm = R2 * M
    i64 = torch.empty(5 * rm + 6 * R2, dtype=torch.int64, device=dev)
    f64 = torch.empty(2 * rm, dtype=torch.float64, device=dev)
    fwd = torch.empty(R2, dtype=torch.bool, device=dev)
    planes = tuple(i64[k * rm:(k + 1) * rm].view(R2, M) for k in range(5))
    planes += (f64[:rm].view(R2, M), f64[rm:].view(R2, M),
               i64[5 * rm:5 * rm + R2], i64[5 * rm + R2:5 * rm + 2 * R2],
               fwd)
    return planes, i64[5 * rm + 2 * R2:].view(R2, 4)


def _first_run(kind, fblob, iblob, P: RelParams, R: int, max_m: int):
    planes, cov = _main_planes(fblob, iblob, P, R, max_m)
    tail = _rescue_tail(planes, P, pack=True)
    out = _dp_run(kind, planes, cov, P, tail=tail, blobs=(iblob, fblob))
    return (planes, cov) + out + (tail[0], tail[1], tail[3])


def rel_dp_first(fblob, iblob, P: RelParams, R: int, max_m: int):
    """The main path's first DP pass in one launch: its prologue writes the
    DP's planes from the chunk's blobs (iblob int32: b, e, ccb, cce [4 x
    R*max_m] | m [R] | plen [R]; fblob f64: pe [R*max_m]; the prologue
    replaces device_pipeline._rel_only_core :572-626 with the E emission
    of _rel_pipeline :170-174), then the pass with its rescue tail
    (:198-234) and its pack tail (_pack_out :638-651) on the rows it does
    not rescue.  Returns (planes, cov, asgn, dp, margin, rescue bool
    (2R,), the rescue pass's coverages cov2 int64 (2R, 4), packed uint8
    (2R, max_m + 5)): planes as kernels.rel_dp takes them (both scan
    directions, backward rows index-reversed), cov the pass's (2R, 4)
    coverages.  The rescued rows of ``packed`` are ``rel_dp_pack``'s to
    write.  CUDA tensors launch the kernel (one launch); CPU tensors run
    the plain versions (rel.prep_ref, rel_ref, rel.rescue_rows and
    rel.pack_out, which packs every row)."""
    if iblob.device.type == "cpu":
        from classpro_tpu_torch.rel import pack_out, prep_ref, rescue_rows

        planes, cov = prep_ref(fblob, iblob, P, R, max_m)
        a, d, mm = _plain_dp(planes, cov, P)
        rescue, cov2 = rescue_rows(planes, a, P, max_m)
        packed = pack_out(a, mm, torch.zeros_like(rescue), max_m)
        return planes, cov, a, d, mm, rescue, cov2, packed
    _need_cuda(iblob)
    return _first_run("cuda", fblob, iblob, P, R, max_m)


def rel_dp_first_host(fblob, iblob, P: RelParams, R: int, max_m: int):
    """rel_dp_first's kernel body with its prologue and tails compiled by
    g++ (test-only; same contract)."""
    return _first_run("host", fblob.contiguous(), iblob.contiguous(), P, R,
                      max_m)


def _pack_run(kind, planes, cov2, P: RelParams, rescue, mm1, packed):
    R2, M = planes[0].shape
    _need("mm1", mm1, torch.float64, (R2,), planes[0].device)
    _need("packed", packed, torch.uint8, (R2, M + 5), planes[0].device)
    return _dp_run(kind, planes, cov2, P, rescue,
                   tail=(None, None, None, packed, mm1))


def rel_dp_pack(bpos, bcnt, epos, ecnt, max_cc, lf_bcnt, logpE, m, plen,
                fwd, cov2, P: RelParams, rescue, mm1, packed):
    """The rescue pass with its pack tail (the tail replaces the pass
    merge of device_pipeline._rel_pipeline :237-241 and _pack_out
    :638-651): the DP on the rows ``rescue`` flags, with the coverages
    ``cov2``, writes each such row of ``packed`` (uint8 (R2, max_m + 5),
    as rel_dp_first returned it) in place: its assignments,
    flags risky(min(mm1, margin)) | 2, f32 of that margin.  Returns the
    pass's (asgn, dp, margin), the other rows' unwritten.  CUDA tensors
    launch the kernel (one launch); CPU tensors run the plain versions
    (rel_ref and rel.pack_ref)."""
    planes = (bpos, bcnt, epos, ecnt, max_cc, lf_bcnt, logpE, m, plen, fwd)
    if bpos.device.type == "cpu":
        from classpro_tpu_torch.rel import pack_ref

        a, d, mm = _plain_dp(planes, cov2, P)
        packed[rescue] = pack_ref(a, a, mm1, mm, rescue)[rescue]
        return a, d, mm
    _need_cuda(bpos)
    return _pack_run("cuda", planes, cov2, P, rescue, mm1, packed)


def rel_dp_pack_host(bpos, bcnt, epos, ecnt, max_cc, lf_bcnt, logpE, m,
                     plen, fwd, cov2, P: RelParams, rescue, mm1, packed):
    """rel_dp_pack's kernel body with its pack tail compiled by g++
    (test-only; same contract)."""
    return _pack_run("host", (bpos, bcnt, epos, ecnt, max_cc, lf_bcnt,
                              logpE, m, plen, fwd), cov2, P, rescue, mm1,
                     packed)


def rel_tail_probe(mm, mm_prev=None):
    """The five tail bytes of packed rows (flags, f32 margin) whose margins
    are given, as the DP kernel's pack tail writes them (rel_tail.cuh
    row_tail_byte): the first pass's rows (``mm_prev`` None, margin
    ``mm``) or the rescue pass's (the min of ``mm_prev`` and ``mm``,
    rescued).  Test-only: it holds the merge and the f32 conversion on
    margins no DP pass gives (NaN, -0, subnormals) against
    rel.pack_ref; no path runs it.  CUDA tensors launch the probe kernel
    built with the DP kernel (not counted in LAUNCHES), CPU tensors run
    its g++ build.  Returns uint8 (n, 5)."""
    dev = mm.device
    n = mm.shape[0]
    _need("mm", mm, torch.float64, (n,), dev)
    if mm_prev is not None:
        _need("mm_prev", mm_prev, torch.float64, (n,), dev)
    out = torch.empty((n, 5), dtype=torch.uint8, device=dev)
    args = [_ptr(mm_prev), mm.data_ptr(), n, out.data_ptr()]
    if dev.type == "cuda":
        fn = _entry("rel_dp", "cuda", "rel_tail_probe_launch",
                    [_PTR, _PTR, _I, _PTR, _PTR])
        with torch.cuda.device(dev):
            err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        err = _entry("rel_dp", "host", "rel_tail_probe_host",
                     [_PTR, _PTR, _I, _PTR])(*args)
    if err != 0:
        raise RuntimeError(f"rel_tail_probe failed: error {err}")
    return out


_UNREL_IN = (("is_rel", torch.bool, ()), ("asgn", torch.int32, ()),
             ("P13", torch.float64, (13,)), ("packL", torch.float64, (3,)),
             ("packR", torch.float64, (3,)), ("idx_desc", torch.int32, ()),
             ("idx_asc", torch.int32, ()), ("live", torch.bool, ()))


def _unrel_args(ins, n, P: UnrelParams, device, kind, gate=None):
    """Checks of the sweep inputs; outputs (with ``gate``, the (2, B) margin
    gates, the packed rows: uint8 (B, N + 1)), the rows' scratch (the card
    needs it only where they do not fit its shared memory; the shim
    always) and the flat C argument list (UR_ARGS_DECL)."""
    if ins[1].dim() != 2:
        raise ValueError("asgn must be (B, N)")
    B, N = ins[1].shape
    for (name, dt, tail), t in zip(_UNREL_IN, ins):
        if t.dtype != dt or tuple(t.shape) != (B, N) + tail:
            raise ValueError(f"{name}: want {dt} {(B, N) + tail}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if n.dtype != torch.int32 or tuple(n.shape) != (B,):
        raise ValueError(f"n: want torch.int32 ({B},), got {n.dtype} "
                         f"{tuple(n.shape)}")
    for t in list(ins) + [n, P.tab, P.lf_small, P.btg_flat]:
        if t.device != device:
            raise ValueError(f"tensor on {t.device}, kernel on {device}")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
    if P.btg_flat.numel() != P.n_cap * P.n_cap:
        raise ValueError("btg_flat must hold n_cap * n_cap entries")
    if gate is None:
        out = torch.empty((B, N), dtype=torch.int8, device=device)
    else:
        _need("gate", gate, torch.float64, (2, B), device)
        out = torch.empty((B, N + 1), dtype=torch.uint8, device=device)
    mm = torch.empty((B,), dtype=torch.float64, device=device)
    geo = unrel_geometry(B, N, kind)
    scratch = None
    if kind == "host" or geo["smem_bytes"] == 0:
        scratch = torch.empty((max(B * geo["row_bytes"], 1),),
                              dtype=torch.uint8, device=device)
    args = ([t.data_ptr() for t in ins]
            + [n.data_ptr(), _ptr(gate), out.data_ptr(), mm.data_ptr(),
               _ptr(scratch), B, N]
            + [P.tab.data_ptr(), P.lf_small.data_ptr(),
               int(P.lf_small.shape[0]), P.btg_flat.data_ptr(),
               int(P.n_cap), float(P.read_len), float(P.r_logp),
               float(P.log_1m_pe_mean), float(P.log_pe_mean),
               float(P.dr_ratio), int(P.cov_r), int(P.cov_h),
               int(P.cov_d)])
    return args, out, mm, scratch


def unrel_sweeps(is_rel, asgn, P13, packL, packR, idx_desc, idx_asc, live,
                 n, P: UnrelParams, gate=None):
    """Both relaxation sweeps (unrel_ref.unrel_sweeps_ref's contract; the
    kernel replaces unrel_dev2.unrel_sweeps2, unrel_dev2.py:67-283):
    returns (asgn int8 (B, N), min decision margin f64 (B,)).  With
    ``gate`` (f64 (2, B), the reads' margin gates rel_settle wrote) the
    kernel's gate tail runs and the first output is the packed uint8
    (B, N + 1): each row's assignment bytes, then its guard flag lo <=
    margin <= hi (the tail replaces classify_batch_dev's flag,
    device_pipeline.py:698-705).  CUDA tensors launch the kernel on the
    current stream; CPU tensors run the plain torch versions (unrel_ref,
    alldev.gate_ref)."""
    ins = (is_rel, asgn, P13, packL, packR, idx_desc, idx_asc, live)
    if asgn.device.type == "cpu":
        from classpro_tpu_torch.alldev import gate_ref
        from classpro_tpu_torch.unrel_ref import unrel_sweeps_ref

        out, mm = unrel_sweeps_ref(*ins, n, P)
        return (out, mm) if gate is None else (gate_ref(out, mm, gate), mm)
    _need_cuda(asgn)
    args, out, mm, _scratch = _unrel_args(ins, n, P, asgn.device, "cuda",
                                          gate)
    _launch("unrel_sweeps", asgn.device, args)
    TAIL_LAUNCHES["gate"] += gate is not None
    return out, mm


def unrel_sweeps_host(is_rel, asgn, P13, packL, packR, idx_desc, idx_asc,
                      live, n, P: UnrelParams, gate=None):
    """The sweep kernel's warp body (with ``gate`` its gate tail) compiled
    by g++ and run on CPU tensors, a warp's 32 lanes phase by phase
    (test-only; same contract as ``unrel_sweeps``)."""
    ins = tuple(t.contiguous() for t in (is_rel, asgn, P13, packL, packR,
                                         idx_desc, idx_asc, live))
    args, out, mm, _scratch = _unrel_args(
        ins, n.contiguous(), P, torch.device("cpu"), "host",
        None if gate is None else gate.contiguous())
    if _fn("unrel_sweeps", "host")(*args) != 0:
        raise RuntimeError("host shim failed")
    return out, mm


# ------------------------------------------------------------- the glue

# the margin gate of a read whose rel margins are not risky: the sweeps'
# margin v clamped to [GATE_UNFLAGGED] equals v exactly when 0 < v < 1e-5
# (the smallest positive double, the double below 1e-5); a risky read's
# gate is [-inf, inf]
GATE_UNFLAGGED = (math.ulp(0.0), math.nextafter(REL_MARGIN_EPS, 0.0))


def blob_views(fblob: torch.Tensor, iblob: torch.Tensor, Bn: int,
               max_n: int, R2: int, max_m: int) -> dict:
    """Views of the all-device path's two blobs (layout in alldev.py) in
    their own types, no copies: the offsets rel_prep reads in that
    layout."""
    R = R2 // 2
    un_sz, rel_sz = Bn * max_n, R2 * max_m
    V = {}
    o = 0
    for k in ("b", "e", "cb", "ce", "ccb", "cce", "idx_desc", "idx_asc",
              "is_rel", "live"):
        V[k] = iblob[o:o + un_sz].view(Bn, max_n)
        o += un_sz
    V["n"] = iblob[o:o + Bn]
    o += Bn
    for k in ("bpos", "bcnt", "epos", "ecnt", "max_cc"):
        V[k] = iblob[o:o + rel_sz].view(R2, max_m)
        o += rel_sz
    V["rel_cols"] = iblob[o:o + R * max_m].view(R, max_m)
    o += R * max_m
    for k in ("m", "plen", "fwd"):
        V[k] = iblob[o:o + R2]
        o += R2
    V["rel_rows"] = iblob[o:o + R]

    of = 0
    for k in ("pe", "peob", "peoe", "lf_cb", "lf_ce"):
        V[k] = fblob[of:of + un_sz].view(Bn, max_n)
        of += un_sz
    for k in ("pe_rel", "lf_bcnt", "lf_ecnt"):
        V[k] = fblob[of:of + rel_sz].view(R2, max_m)
        of += rel_sz
    return V


def _need(name, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: want {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} on {t.device}, kernel on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _shim(name: str, args) -> None:
    """Run glue kernel ``name``'s g++ shim on CPU tensors."""
    if _fn(name, "host")(*args) != 0:
        raise RuntimeError(f"{name} host shim failed")


def glue_geometry(kernel: str, n: int, kind: str = "cuda",
                  n2: int = 0) -> dict:
    """Threads per block, blocks and shared bytes per block (static and
    dynamic) of a glue launch, as glue.cu computes them: ``rel_prep``
    over ``n`` rel-plane and ``n2`` interval cells, ``rel_settle`` over
    ``n`` read pairs of max_m ``n2``."""
    out = (ctypes.c_int * 3)()
    _entry("rel_prep", kind, "glue_geometry", [_I, _LL, _LL, _PTR])(
        GLUE_KERNELS.index(kernel), n, n2, ctypes.cast(out, _PTR))
    return {"threads_per_block": out[0], "blocks": out[1],
            "smem_bytes": out[2]}


def _prep_args(fblob, iblob, P: RelParams, R: int, max_m: int, alldev):
    """Checks of rel_prep's inputs; its outputs (the DP's planes and first
    coverages, the sweeps' planes and the margin gate) and the flat C
    argument list (GP_ARGS_DECL)."""
    dev = iblob.device
    R2, M = 2 * R, max_m
    Bn, N = alldev
    n_i = 10 * Bn * N + Bn + 5 * R2 * M + R * M + 3 * R2 + R
    n_f = 5 * Bn * N + 3 * R2 * M
    _need("iblob", iblob, torch.int32, (n_i,), dev)
    _need("fblob", fblob, torch.float64, (n_f,), dev)
    for name, t in (("logfact", P.logfact), ("gcov", P.gcov)):
        _need(name, t, t.dtype, t.shape, dev)
    if P.logfact.dtype != torch.float64 or P.gcov.dtype != torch.int64:
        raise ValueError("RelParams: logfact must be f64, gcov int64")
    i64 = torch.empty(5 * R2 * M + 6 * R2, dtype=torch.int64, device=dev)
    f64 = torch.empty(R2 * M + 19 * Bn * N + 2 * Bn, dtype=torch.float64,
                      device=dev)
    u8 = torch.empty(R2 + 2 * Bn * N, dtype=torch.bool, device=dev)
    asgn = torch.empty((Bn, N), dtype=torch.int32, device=dev)
    rm = R2 * M
    pl = [i64[k * rm:(k + 1) * rm].view(R2, M) for k in range(5)]
    m, plen = i64[5 * rm:5 * rm + R2], i64[5 * rm + R2:5 * rm + 2 * R2]
    cov = i64[5 * rm + 2 * R2:].view(R2, 4)
    lf_bcnt = blob_views(fblob, iblob, Bn, N, R2, M)["lf_bcnt"]
    logpE, o = f64[:rm].view(R2, M), rm
    P13 = f64[o:o + 13 * Bn * N].view(Bn, N, 13)
    packL = f64[o + 13 * Bn * N:o + 16 * Bn * N].view(Bn, N, 3)
    packR = f64[o + 16 * Bn * N:o + 19 * Bn * N].view(Bn, N, 3)
    gate = f64[o + 19 * Bn * N:].view(2, Bn)
    fwd = u8[:R2]
    is_rel = u8[R2:R2 + Bn * N].view(Bn, N)
    live = u8[R2 + Bn * N:].view(Bn, N)
    planes = tuple(pl) + (lf_bcnt, logpE, m, plen, fwd)
    outs = (pl[0], pl[1], pl[2], pl[3], pl[4], m, plen, cov, logpE, fwd,
            is_rel, live, asgn, P13, packL, packR, gate)
    args = ([iblob.data_ptr(), fblob.data_ptr(), P.logfact.data_ptr(),
             P.gcov.data_ptr(), float(P.e_po_base), R, M, Bn, N,
             GATE_UNFLAGGED[0], GATE_UNFLAGGED[1]]
            + [t.data_ptr() for t in outs])
    un = {"is_rel": is_rel, "asgn": asgn, "P13": P13, "packL": packL,
          "packR": packR, "live": live, "gate": gate}
    return args, planes, cov, un


def rel_prep(fblob, iblob, P: RelParams, R: int, max_m: int, alldev):
    """The DP's and the sweeps' planes of one all-device chunk from its
    blobs, ``alldev`` = (Bn, max_n) (the kernel replaces
    device_pipeline._unpack :119 + _un_planes :511-538 + the sweeps'
    N_STATE rows, with the E emission of _rel_pipeline :170-174): returns
    (planes, cov, un) with planes as kernels.rel_dp takes them, cov the
    first pass's (2R, 4) coverages and un a dict of the sweeps' is_rel,
    asgn, P13, packL, packR, live and the (2, Bn) margin gate.  (The main
    layout's planes are rel_dp_first's prologue.)  CUDA tensors launch
    the kernel; CPU tensors run the plain version (alldev.prep_ref)."""
    if iblob.device.type == "cpu":
        from classpro_tpu_torch.alldev import prep_ref

        return prep_ref(fblob, iblob, P, R, max_m, *alldev)
    _need_cuda(iblob)
    args, planes, cov, un = _prep_args(fblob, iblob, P, R, max_m, alldev)
    _launch("rel_prep", iblob.device, args)
    return planes, cov, un


def rel_prep_host(fblob, iblob, P: RelParams, R: int, max_m: int, alldev):
    """rel_prep's block body compiled by g++ and run on CPU tensors
    (test-only; same contract)."""
    args, planes, cov, un = _prep_args(fblob.contiguous(),
                                       iblob.contiguous(), P, R, max_m,
                                       alldev)
    _shim("rel_prep", args)
    return planes, cov, un


def _row_planes(planes, device):
    """Checks of the planes rel_settle reads (bpos, bcnt, epos, ecnt, m,
    fwd); returns (R2, max_m)."""
    R2, M = planes[0].shape
    for k, name in ((0, "bpos"), (1, "bcnt"), (2, "epos"), (3, "ecnt")):
        _need(name, planes[k], torch.int64, (R2, M), device)
    _need("m", planes[7], torch.int64, (R2,), device)
    _need("fwd", planes[9], torch.bool, (R2,), device)
    return R2, M


def _passes(asgn1, asgn2, mm1, mm2, rescue):
    """Checks of the two DP passes' outputs; returns (R2, max_m)."""
    dev = asgn1.device
    R2, M = asgn1.shape
    for name, t, dt, shape in (("asgn1", asgn1, torch.int8, (R2, M)),
                               ("asgn2", asgn2, torch.int8, (R2, M)),
                               ("mm1", mm1, torch.float64, (R2,)),
                               ("mm2", mm2, torch.float64, (R2,)),
                               ("rescue", rescue, torch.bool, (R2,))):
        _need(name, t, dt, shape, dev)
    return R2, M


def _settle_args(asgn1, asgn2, mm1, mm2, rescue, planes, rel_rows,
                 rel_cols, P: RelParams, asgn, gate):
    dev = asgn1.device
    R2, M = _passes(asgn1, asgn2, mm1, mm2, rescue)
    if _row_planes(planes, dev) != (R2, M) or R2 % 2:
        raise ValueError("planes must match the passes' (R2, max_m)")
    R = R2 // 2
    if asgn.dim() != 2:
        raise ValueError("asgn must be (Bn, max_n)")
    Bn, N = asgn.shape
    for name, t, dt, shape in (("rel_rows", rel_rows, torch.int32, (R,)),
                               ("rel_cols", rel_cols, torch.int32, (R, M)),
                               ("gcov", P.gcov, torch.int64, (4,)),
                               ("asgn", asgn, torch.int32, (Bn, N)),
                               ("gate", gate, torch.float64, (2, Bn))):
        _need(name, t, dt, shape, dev)
    return ([t.data_ptr() for t in (asgn1, asgn2, mm1, mm2, rescue)]
            + [planes[k].data_ptr() for k in (0, 1, 2, 3, 7, 9)]
            + [rel_rows.data_ptr(), rel_cols.data_ptr(), P.gcov.data_ptr(),
               R, M, Bn, N, asgn.data_ptr(), gate.data_ptr()])


def rel_settle(asgn1, asgn2, mm1, mm2, rescue, planes, rel_rows, rel_cols,
               P: RelParams, asgn, gate) -> None:
    """The all-device path's rel tail (the kernel replaces the pass merge
    of device_pipeline._rel_pipeline :237-241, _demotes_dev :257-294,
    _reconcile_dev :401-447 and classify_batch_dev's scatter and rel flag
    :686-704): writes each read pair's reconciled row into the sweeps'
    ``asgn`` (Bn, max_n) at (rel_rows, rel_cols), sentinels dropped, and
    opens the read's margin ``gate`` (2, Bn) when its rel margin is
    risky.  CUDA tensors launch the kernel; CPU tensors run the plain
    version (alldev.settle_ref)."""
    if asgn1.device.type == "cpu":
        from classpro_tpu_torch.alldev import settle_ref

        return settle_ref(asgn1, asgn2, mm1, mm2, rescue, planes, rel_rows,
                          rel_cols, P, asgn, gate)
    _need_cuda(asgn1)
    _launch("rel_settle", asgn1.device, _settle_args(
        asgn1, asgn2, mm1, mm2, rescue, planes, rel_rows, rel_cols, P, asgn,
        gate))


def rel_settle_host(asgn1, asgn2, mm1, mm2, rescue, planes, rel_rows,
                    rel_cols, P: RelParams, asgn, gate) -> None:
    """rel_settle's warp body compiled by g++ (test-only; same contract)."""
    _shim("rel_settle", _settle_args(
        asgn1, asgn2, mm1, mm2, rescue, planes, rel_rows, rel_cols, P, asgn,
        gate))
