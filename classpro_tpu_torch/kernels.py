"""Build and bind the reliable-interval DP kernel (csrc/rel_dp.cu).

``rel_dp`` is the wrapper the main path calls: on a CUDA tensor it
launches the sm_90a kernel (one thread per DP row, see rel_dp.cu) on the
current stream and counts the launch in ``LAUNCHES``; on a CPU tensor it
runs the plain torch version (rel_ref.rel_dp_ref).  There is no fallback
between the two: a failed nvcc build or a refused launch raises.

The kernel is compiled at first use with nvcc into ``_build/`` (plain C
interface, loaded with ctypes), never at import.  ``rel_dp_host`` runs the
same per-row body compiled by g++ (rel_dp_row.cuh under -x c++); it is
the CPU tests' window onto the kernel's arithmetic and never runs on the
main path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import torch

from classpro_tpu_torch.params import RelParams

_HERE = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_HERE, "csrc")
_CU = os.path.join(_CSRC, "rel_dp.cu")
_DEPS = (_CU, os.path.join(_CSRC, "rel_dp_row.cuh"))
_BUILD = os.path.join(_HERE, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC"]
HOST_FLAGS = ["-O2", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
              "-x", "c++"]

# launches of the CUDA kernel (plain-version calls on the CPU do not count)
LAUNCHES = {"rel_dp": 0}
# nvcc's output of the last build in this process (the -Xptxas -v lines)
BUILD_LOG: dict = {}

_lock = threading.Lock()
_libs: dict = {}

_PTR = ctypes.c_void_p
# rel_dp.cu RD_ARGS_DECL
_ARGTYPES = ([_PTR] * 17 + [ctypes.c_int, ctypes.c_int, _PTR, _PTR,
                            ctypes.c_int, ctypes.c_double,
                            ctypes.c_longlong] + [ctypes.c_double] * 4)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def _stale(so: str) -> bool:
    return not os.path.exists(so) or any(
        os.path.getmtime(d) > os.path.getmtime(so) for d in _DEPS)


def _compile(cmd: list, so: str, key: str) -> None:
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


def build(kind: str = "cuda", force: bool = False) -> str:
    """Compile the kernel (``cuda``: nvcc for sm_90a) or the host test
    shim (``host``: g++) if its sources changed; returns the .so path."""
    if kind == "cuda":
        so = os.path.join(_BUILD, "librel_dp_cuda.so")
        cmd = [_nvcc()] + NVCC_FLAGS + ["-I", _CSRC, _CU]
    elif kind == "host":
        so = os.path.join(_BUILD, "librel_dp_host.so")
        cmd = ["g++"] + HOST_FLAGS + ["-I", _CSRC, _CU]
    else:
        raise ValueError(kind)
    if force or _stale(so):
        _compile(cmd, so, kind)
    return so


def _lib(kind: str):
    with _lock:
        lib = _libs.get(kind)
        if lib is None:
            lib = ctypes.CDLL(build(kind))
            fn = lib.rel_dp_launch if kind == "cuda" else lib.rel_dp_host
            fn.restype = ctypes.c_int
            fn.argtypes = _ARGTYPES + ([_PTR] if kind == "cuda" else [])
            _libs[kind] = lib
        return lib


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
    """One merged-direction DP pass (rel_ref.rel_dp_ref's contract):
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
    lib = _lib("cuda")
    stream = torch.cuda.current_stream(bpos.device).cuda_stream
    with torch.cuda.device(bpos.device):
        err = lib.rel_dp_launch(*args, stream)
    if err != 0:
        raise RuntimeError(f"rel_dp kernel launch failed: CUDA error {err}")
    LAUNCHES["rel_dp"] += 1
    return keep[0], keep[1], keep[2]


def rel_dp_host(bpos, bcnt, epos, ecnt, max_cc, lf_bcnt, logpE, m, plen,
                fwd, cov, P: RelParams, active=None):
    """The kernel's per-row body compiled by g++ and run on CPU tensors
    (test-only; same contract as ``rel_dp``)."""
    planes = tuple(t.contiguous() for t in (bpos, bcnt, epos, ecnt, max_cc,
                                             lf_bcnt, logpE, m, plen, fwd))
    cov = cov.contiguous()
    R2, M = _check(planes, cov, active, torch.device("cpu"))
    args, keep = _args(planes, cov, P, active, R2, M)
    if _lib("host").rel_dp_host(*args) != 0:
        raise RuntimeError("host shim failed")
    return keep[0], keep[1], keep[2]
