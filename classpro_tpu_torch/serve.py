"""Persistent warm-engine service (the cold-start amortization story).

A run-once ``cli classify`` on the card pays a cold start: the nvcc build
or load of the kernels, the CUDA context, and the 94.6 MB packed Skellam
table (built by numpy, then uploaded).  ``cli serve`` pays it once per
service lifetime: the daemon loads the kernels and uploads the tables
(``params.device_tables``, one copy per device and process) before it
takes traffic, every job's engine shares them, and successive
``cli classify --server`` jobs attach over a unix socket.  Only a job's
model-dependent parameters (``lf_small``, the scalars, the coverages) are
built per job.

Protocol (that of the JAX package's daemon): one JSON object per line,
one reply line per request.
  {"cmd": "ping"}                      -> {"ok": true, "pid": N,
                                           "warm_shapes": [[R, m], ...]}
  {"cmd": "classify", "source": ..., "output": ...,
   "fastk_root"|"coverage"|"read_len"|"model"|"batch_size"|"threads"|
   "warmup" optional}                  -> {"ok": true, "wall_s": S,
                                           "reads": N, "kmers": N,
                                           "guard_flagged": N,
                                           "launches": {kernel: N}, ...}
  {"cmd": "stats"}                     -> {"ok": true, "jobs": N,
                                           "table_uploads": N,
                                           "launches": {kernel: N}, ...}
  {"cmd": "shutdown"}                  -> {"ok": true}

A classify reply's ``launches`` are the kernel launches of that job and
``graphs`` its main-chunk CUDA graphs' captures and replays (on a card a
chunk is one replay, captured per bucket at first use; its two launches
count once per replay); ``stats`` carries the process totals (warm-up
included), the table uploads and the Python threads alive.  Jobs run
serially, on the daemon's device; a job's error is replied (``ok:
false``) and never ends the daemon.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time
import traceback


def _warm_shapes() -> list[list[int]]:
    from classpro_tpu_torch.engine import WARM_SHAPES

    return sorted([R, m] for R, m in WARM_SHAPES)


def _launches() -> dict:
    from classpro_tpu_torch import kernels

    return dict(kernels.LAUNCHES)


def _graphs() -> dict:
    from classpro_tpu_torch.rel import GRAPH_COUNTS

    return dict(GRAPH_COUNTS)


def _make_warm(device, warmup_root: str | None, warmup_shapes: tuple,
               verbose: bool) -> None:
    """Load the kernels (cuda), upload the tables and, given a dataset
    root, warm the DP for ``warmup_shapes`` with that dataset's model.
    Raises when the device, the compiler or a launch is missing."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.params import device_tables

    if device.type == "cuda":
        for name in kernels.SOURCES:
            kernels._fn(name, "cuda")
    device_tables(device)
    if warmup_root:
        from classpro_tpu_torch.engine import TorchEngine
        from classpro_tpu_torch.estimation import build_global_model
        from classpro_tpu_torch.io.fastk import load_histogram

        gm = build_global_model(load_histogram(warmup_root))
        eng = TorchEngine(gm, verbose=verbose, device=device)
        t0 = time.time()
        eng.warmup(warmup_shapes or ((256, 128), (256, 192)))
        if verbose:
            print(f"serve: warmed {_warm_shapes()} in "
                  f"{time.time() - t0:.1f}s", file=sys.stderr)


def _do_classify(req: dict, device) -> dict:
    """One classify job: the .class file written through the output plane
    (``ClassifyJob.write``), complete and closed before the reply."""
    from classpro_tpu_torch.engine import ClassifyJob
    from classpro_tpu_torch.io.fastx import root_of

    source = req["source"]
    root = root_of(source)
    out = req.get("output") or root + ".class"
    before, g0 = _launches(), _graphs()
    t0 = time.time()
    st: dict = {}
    w = ClassifyJob(
        source, req.get("fastk_root") or root,
        coverage=int(req.get("coverage", 0)),
        read_len=int(req.get("read_len", 20000)),
        model_path=req.get("model"),
        batch_size=int(req.get("batch_size", 200)),
        threads=int(req.get("threads", 0)),
        warmup=bool(req.get("warmup", False)), device=device,
        stats_out=st).write(out)
    after, g1 = _launches(), _graphs()
    return {"ok": True, "output": out, "reads": w.reads, "kmers": w.kmers,
            "wall_s": time.time() - t0, "output_s": w.seconds,
            "guard_flagged": st.get("guard_flagged", 0),
            "launches": {k: after[k] - before[k] for k in after},
            "graphs": {k: g1[k] - g0[k] for k in g1},
            "warm_shapes": _warm_shapes()}


def _after_error(device) -> None:
    """Let a failed job's queued device work end before the next job."""
    if device.type == "cuda":
        import torch

        try:
            torch.cuda.synchronize(device)
        except RuntimeError:
            pass            # a broken context fails the next job itself


def serve(sock_path: str, warmup_root: str | None = None,
          warmup_shapes: tuple = (), verbose: bool = False,
          device=None) -> int:
    """Run the daemon on ``device`` (default ``cuda``) until a shutdown
    request (or SIGTERM)."""
    from classpro_tpu_torch.device import canonical_device
    from classpro_tpu_torch import params

    device = canonical_device(device)
    _make_warm(device, warmup_root, warmup_shapes, verbose)
    try:
        os.unlink(sock_path)
    except OSError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    srv.listen(8)

    stats = {"jobs": 0, "errors": 0, "started": time.time()}
    if verbose:
        print(f"serve: listening on {sock_path} ({device})", file=sys.stderr)
    print("READY", flush=True)    # startup handshake for supervisors

    while True:
        conn, _ = srv.accept()
        req: dict = {}
        try:
            f = conn.makefile("rwb")
            line = f.readline()
            if not line:
                continue
            try:
                req = json.loads(line)
                cmd = req.get("cmd")
                if cmd == "ping":
                    rep = {"ok": True, "pid": os.getpid(),
                           "warm_shapes": _warm_shapes()}
                elif cmd == "stats":
                    rep = dict(ok=True, warm_shapes=_warm_shapes(),
                               uptime_s=time.time() - stats["started"],
                               device=str(device),
                               table_uploads=params.TABLE_UPLOADS,
                               launches=_launches(), graphs=_graphs(),
                               threads=threading.active_count(),
                               **{k: v for k, v in stats.items()
                                  if k != "started"})
                elif cmd == "classify":
                    stats["jobs"] += 1
                    rep = _do_classify(req, device)
                elif cmd == "shutdown":
                    rep = {"ok": True}
                else:
                    rep = {"ok": False, "error": f"unknown cmd {cmd!r}"}
            except Exception as e:   # job errors must not kill the daemon
                stats["errors"] += 1
                traceback.print_exc(file=sys.stderr)
                _after_error(device)
                rep = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            try:
                f.write(json.dumps(rep).encode() + b"\n")
                f.flush()
            except OSError:
                pass                 # the client went away
            if isinstance(req, dict) and req.get("cmd") == "shutdown" \
                    and rep.get("ok"):
                break
        finally:
            conn.close()
    srv.close()
    try:
        os.unlink(sock_path)
    except OSError:
        pass
    return 0


def request(sock_path: str, req: dict, timeout: float = 0.0) -> dict:
    """Send one request; return the parsed reply.  ``timeout`` bounds
    CONNECT only — a classify job legitimately runs for minutes, so the
    reply read is unbounded by default."""
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    if timeout > 0:
        c.settimeout(timeout)
    c.connect(sock_path)
    c.settimeout(None)
    f = c.makefile("rwb")
    f.write(json.dumps(req).encode() + b"\n")
    f.flush()
    line = f.readline()
    c.close()
    if not line:
        raise RuntimeError(f"server at {sock_path} closed the connection "
                           f"without replying")
    return json.loads(line)
