"""Build and bind the hand-written CUDA kernels (csrc/).

``rel_dp`` (csrc/rel_dp.cu: the reliable-interval DP) and
``unrel_sweeps`` (csrc/unrel.cu: the two relaxation sweeps) are the
wrappers the paths call: on CUDA tensors they launch the sm_90a kernel
(eight lanes per DP row; four lanes per sweep row) on the current
stream and count the launch in ``LAUNCHES``; on CPU tensors they run the
plain torch version (rel_ref, unrel_ref).  There is no fallback between
the two: a failed nvcc build or a refused launch raises.

Each kernel is compiled at first use with nvcc into ``_build/`` (plain C
interface, loaded with ctypes), never at import.  ``rel_dp_host`` and
``unrel_sweeps_host`` run the same warp bodies compiled by g++ (the
headers under -x c++, a warp's 32 lanes phase by phase); they are the CPU
tests' window onto the kernels' arithmetic and lane exchanges and never
run on a path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import torch

from classpro_tpu_torch.params import RelParams, UnrelParams

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_BUILD = os.path.join(_HERE, "_build")
# kernel -> (source, headers it includes)
SOURCES = {
    "rel_dp": ("rel_dp.cu", ("rel_dp_row.cuh", "rd_math.cuh",
                             "warp_lanes.cuh")),
    "unrel_sweeps": ("unrel.cu", ("unrel_row.cuh", "rd_math.cuh",
                                  "warp_lanes.cuh")),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]
HOST_FLAGS = ["-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
              "-x", "c++"]

# launches of the CUDA kernels (plain-version calls on the CPU do not count)
LAUNCHES = {"rel_dp": 0, "unrel_sweeps": 0}
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
    "rel_dp": [_PTR] * 17 + [_I, _I, _PTR, _PTR, _I, _D, _LL] + [_D] * 4,
    "unrel_sweeps": ([_PTR] * 12 + [_I, _I, _PTR, _PTR, _I, _PTR, _I]
                     + [_D] * 5 + [_LL] * 3),
}
_ENTRY = {("rel_dp", "cuda"): "rel_dp_launch", ("rel_dp", "host"): "rel_dp_host",
          ("unrel_sweeps", "cuda"): "unrel_launch",
          ("unrel_sweeps", "host"): "unrel_host"}


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


def _args(planes, cov, P: RelParams, active, R2, M):
    """Outputs, scratch and the flat C argument list (RD_ARGS_DECL)."""
    dev = planes[0].device
    asgn = torch.empty((R2, M), dtype=torch.int8, device=dev)
    dp = torch.empty((R2, 4), dtype=torch.float64, device=dev)
    mm = torch.empty((R2,), dtype=torch.float64, device=dev)
    bp = torch.empty((R2, max(M - 1, 1), 4), dtype=torch.int8, device=dev)
    rpos = torch.empty((R2, M), dtype=torch.uint8, device=dev)
    if P.tab.device != dev or P.lf_small.device != dev:
        raise ValueError("RelParams must live on the kernel's device")
    if P.tab.dtype != torch.float64 or not P.tab.is_contiguous():
        raise ValueError("packed table must be contiguous f64")
    ptrs = [t.data_ptr() for t in planes] + [cov.data_ptr(),
                                            active.data_ptr()
                                            if active is not None else None]
    ptrs += [asgn.data_ptr(), dp.data_ptr(), mm.data_ptr(), bp.data_ptr(),
             rpos.data_ptr()]
    args = ptrs + [R2, M, P.tab.data_ptr(), P.lf_small.data_ptr(),
                   int(P.lf_small.shape[0]), float(P.read_len),
                   int(P.offset), float(P.r_logp), float(P.log_1m_pe_mean),
                   float(P.log_pe_mean), float(P.dr_ratio)]
    keep = (asgn, dp, mm, bp, rpos)
    return args, keep


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
        from classpro_tpu_torch.rel_ref import rel_dp_ref

        return rel_dp_ref(*planes, cov, P)
    if bpos.device.type != "cuda":
        raise ValueError(f"no kernel for device {bpos.device}")
    R2, M = _check(planes, cov, active, bpos.device)
    args, keep = _args(planes, cov, P, active, R2, M)
    _launch("rel_dp", bpos.device, args)
    return keep[0], keep[1], keep[2]


def rel_dp_host(bpos, bcnt, epos, ecnt, max_cc, lf_bcnt, logpE, m, plen,
                fwd, cov, P: RelParams, active=None):
    """The kernel's warp body compiled by g++ and run on CPU tensors, a
    warp's 32 lanes phase by phase (test-only; same contract as
    ``rel_dp``)."""
    planes = tuple(t.contiguous() for t in (bpos, bcnt, epos, ecnt, max_cc,
                                             lf_bcnt, logpE, m, plen, fwd))
    cov = cov.contiguous()
    R2, M = _check(planes, cov, active, torch.device("cpu"))
    args, keep = _args(planes, cov, P, active, R2, M)
    if _fn("rel_dp", "host")(*args) != 0:
        raise RuntimeError("host shim failed")
    return keep[0], keep[1], keep[2]


_UNREL_IN = (("is_rel", torch.bool, ()), ("asgn", torch.int32, ()),
             ("P13", torch.float64, (13,)), ("packL", torch.float64, (3,)),
             ("packR", torch.float64, (3,)), ("idx_desc", torch.int32, ()),
             ("idx_asc", torch.int32, ()), ("live", torch.bool, ()))


def _unrel_args(ins, n, P: UnrelParams, device, kind):
    """Checks of the sweep inputs; outputs, the rows' scratch (the card
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
    asgn = torch.empty((B, N), dtype=torch.int8, device=device)
    mm = torch.empty((B,), dtype=torch.float64, device=device)
    geo = unrel_geometry(B, N, kind)
    scratch = None
    if kind == "host" or geo["smem_bytes"] == 0:
        scratch = torch.empty((max(B * geo["row_bytes"], 1),),
                              dtype=torch.uint8, device=device)
    args = ([t.data_ptr() for t in ins]
            + [n.data_ptr(), asgn.data_ptr(), mm.data_ptr(),
               scratch.data_ptr() if scratch is not None else None, B, N]
            + [P.tab.data_ptr(), P.lf_small.data_ptr(),
               int(P.lf_small.shape[0]), P.btg_flat.data_ptr(),
               int(P.n_cap), float(P.read_len), float(P.r_logp),
               float(P.log_1m_pe_mean), float(P.log_pe_mean),
               float(P.dr_ratio), int(P.cov_r), int(P.cov_h),
               int(P.cov_d)])
    return args, asgn, mm, scratch


def unrel_sweeps(is_rel, asgn, P13, packL, packR, idx_desc, idx_asc, live,
                 n, P: UnrelParams):
    """Both relaxation sweeps (unrel_ref.unrel_sweeps_ref's contract; the
    kernel replaces unrel_dev2.unrel_sweeps2, unrel_dev2.py:67-283):
    returns (asgn int8 (B, N), min decision margin f64 (B,)).  CUDA
    tensors launch the kernel on the current stream; CPU tensors run the
    plain torch version."""
    ins = (is_rel, asgn, P13, packL, packR, idx_desc, idx_asc, live)
    if asgn.device.type == "cpu":
        from classpro_tpu_torch.unrel_ref import unrel_sweeps_ref

        return unrel_sweeps_ref(*ins, n, P)
    if asgn.device.type != "cuda":
        raise ValueError(f"no kernel for device {asgn.device}")
    args, out, mm, _scratch = _unrel_args(ins, n, P, asgn.device, "cuda")
    _launch("unrel_sweeps", asgn.device, args)
    return out, mm


def unrel_sweeps_host(is_rel, asgn, P13, packL, packR, idx_desc, idx_asc,
                      live, n, P: UnrelParams):
    """The sweep kernel's warp body compiled by g++ and run on CPU tensors,
    a warp's 32 lanes phase by phase (test-only; same contract as
    ``unrel_sweeps``)."""
    ins = tuple(t.contiguous() for t in (is_rel, asgn, P13, packL, packR,
                                         idx_desc, idx_asc, live))
    args, out, mm, _scratch = _unrel_args(ins, n.contiguous(), P,
                                          torch.device("cpu"), "host")
    if _fn("unrel_sweeps", "host")(*args) != 0:
        raise RuntimeError("host shim failed")
    return out, mm
