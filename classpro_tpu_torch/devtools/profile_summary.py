"""Summary of a ``classify --torch-profile`` Chrome trace.

Prints the top N trace events by total duration and the card's busy
share: the union of its kernel, copy and set intervals over the traced
window (first to last event of any kind).  ``trace_share`` is what
chip_smoke.py reads from the trace of its serve phase.

Usage::

    python -m classpro_tpu_torch.devtools.profile_summary \
        <trace.json[.gz] | trace dir> [N]
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import sys

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace(path: str) -> str:
    """``path`` itself, or the newest trace file under a directory."""
    if os.path.isfile(path):
        return path
    hits = sorted((p for pat in ("*.json", "*.json.gz")
                   for p in glob.glob(os.path.join(path, "**", pat),
                                      recursive=True)),
                  key=os.path.getmtime)
    if not hits:
        raise FileNotFoundError(f"no trace (*.json, *.json.gz) under {path}")
    return hits[-1]


def load_events(path: str) -> list:
    """The complete events (``ph`` X, with a duration) of a trace."""
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        return [e for e in json.load(f).get("traceEvents", [])
                if e.get("ph") == "X" and "dur" in e]


def trace_share(path: str) -> dict:
    """The DP kernel's events and the card's busy share (union of its
    kernel, copy and set intervals over the traced window, first to last
    event of any kind)."""
    evs = load_events(path)
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in evs if e.get("cat") in DEVICE_CATS)
    busy, end = 0.0, float("-inf")
    for a, b in dev:
        if b > end:
            busy += b - max(a, end)
            end = b
    lo = min(float(e["ts"]) for e in evs)
    hi = max(float(e["ts"]) + float(e["dur"]) for e in evs)
    k1 = [e for e in evs if e.get("cat") == "kernel"
          and "rel_dp_kernel" in e.get("name", "")]
    return {"events": len(evs), "device_events": len(dev),
            "rel_dp_kernel_events": len(k1),
            "rel_dp_kernel_us": sum(float(e["dur"]) for e in k1),
            "window_us": hi - lo, "device_busy_us": busy,
            "busy_share": busy / max(hi - lo, 1e-9)}


def top_events(path: str, n: int = 30) -> list:
    """(name, category, total us, count) of the ``n`` events with the
    largest total duration."""
    dur: dict = collections.defaultdict(list)
    for e in load_events(path):
        dur[(e.get("name", "?"), e.get("cat", "?"))].append(float(e["dur"]))
    top = sorted(dur.items(), key=lambda kv: -sum(kv[1]))[:n]
    return [(name, cat, sum(ds), len(ds)) for (name, cat), ds in top]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = find_trace(argv[0] if argv else ".")
    n = int(argv[1]) if len(argv) > 1 else 30
    print(f"# {path}")
    print(f"# {'total_ms':>10} {'n':>7} {'avg_us':>10}  category  event")
    for name, cat, tot, cnt in top_events(path, n):
        print(f"{tot / 1e3:10.3f} {cnt:7d} {tot / cnt:10.2f}  {cat:8s}  "
              f"{name[:100]}")
    sh = trace_share(path)
    print(f"# card busy {100 * sh['busy_share']:.2f}% of the "
          f"{sh['window_us']:.0f} us window ({sh['device_events']} device "
          f"events, {sh['rel_dp_kernel_events']} rel_dp_kernel)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
