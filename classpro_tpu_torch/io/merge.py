"""Scatter-gather output merging (ref io.c:15-112).

The reference classifies into per-thread temp files
``<tmp>/<root>.class.<t>`` and concatenates them in read order at the
end (merge_files, io.c:70-112); DAZZ ``.anno`` index streams are merged
with cumulative offset rebasing (merge_anno, io.c:15-56).  The same
scheme is the natural multi-host resume/merge granularity here: each
host writes its read-shard's outputs, then rank 0 merges in shard
order.
"""

from __future__ import annotations

import os
import shutil
import struct


def merge_files(dest: str, parts: list[str], remove: bool = True) -> None:
    """Concatenate part files into dest in order (merge_files,
    io.c:70-112)."""
    with open(dest, "wb") as out:
        for p in parts:
            with open(p, "rb") as f:
                shutil.copyfileobj(f, out, length=1 << 20)
            if remove:
                os.remove(p)


def merge_anno(dest: str, parts: list[str], remove: bool = True) -> None:
    """Merge DAZZ .anno shards with offset rebasing (merge_anno,
    io.c:15-56): the first shard's {nreads, size, 0} header is kept
    (with nreads summed over shards), and every subsequent shard's
    int64 offsets are shifted by the running data size."""
    nreads_total = 0
    size = None
    offsets: list[int] = []
    base = 0
    for p in parts:
        with open(p, "rb") as f:
            n, s = struct.unpack("<ii", f.read(8))
            f.read(8)  # leading idx (always 0 in shard headers)
            nreads_total += n
            if size is None:
                size = s
            elif size != s:
                raise ValueError(f"anno shard size mismatch in {p}")
            raw = f.read()
            offs = struct.unpack(f"<{len(raw) // 8}q", raw)
            offsets.extend(base + o for o in offs)
            if offs:
                base += offs[-1]
    with open(dest, "wb") as out:
        out.write(struct.pack("<iiq", nreads_total, size or 0, 0))
        out.write(struct.pack(f"<{len(offsets)}q", *offsets))
    if remove:
        for p in parts:
            os.remove(p)
