"""The stream's kept host staging: one byte buffer per chunk in flight.

A chunk's host side of the device stage is three arrays: the float64
blob and the int32 blob its C++ packer writes (``NativeWall.pack_rel`` on
the main path, ``NativeWall.pack_chunk`` on the all-device path), and the
uint8 result the device stage returns.  ``StagingPool.take`` hands out a
``Slot``: one buffer holding all three, each at an offset aligned to
``ALIGN`` bytes.  On a card the buffers are pinned (torch's caching host
allocator, ``pin_memory=True``), so the blobs go from the slot straight
into the bucket graph's static inputs and the result straight back into
the slot, both asynchronous on the engine's stream; on the CPU they are
plain memory and the same lifetimes hold.

Every buffer of a pool has the size of the largest chunk it has seen
(rounded up to a power of two): a buffer found smaller than that is
replaced, never resized, so once the stream has met its largest chunk no
take allocates.  The engine releases a slot in ``_finish``, after the
chunk's device event and the last read of its views; a chunk that never
reaches ``_finish`` drops its slot, which is then never reused.
"""

from __future__ import annotations

import math

import torch

ALIGN = 256


def _up(n: int) -> int:
    """``n`` rounded up to a multiple of ALIGN."""
    return -(-n // ALIGN) * ALIGN


def layout(n_f: int, n_i: int, out_shape) -> tuple:
    """Byte offsets of a slot's three views (fblob, iblob, result) and
    its size: (o_f, o_i, o_out, nbytes)."""
    n_out = math.prod(out_shape)
    o_i = _up(8 * n_f)
    o_out = o_i + _up(4 * n_i)
    return 0, o_i, o_out, o_out + _up(n_out)


class Slot:
    """One chunk's host buffers, views into one byte buffer: ``fblob``
    (float64) and ``iblob`` (int32) as numpy arrays for the packers,
    ``fblob_t`` / ``iblob_t`` the same memory as torch tensors, and
    ``out``, the uint8 torch tensor the result comes back into."""

    __slots__ = ("owner", "buf", "fblob", "iblob", "fblob_t", "iblob_t",
                 "out")

    def __init__(self, owner: "_Buffer", n_f: int, n_i: int, out_shape):
        o_f, o_i, o_out, _ = layout(n_f, n_i, out_shape)
        self.owner, self.buf = owner, owner.t
        b = owner.t[owner.base:]
        self.fblob_t = b[o_f: o_f + 8 * n_f].view(torch.float64)
        self.iblob_t = b[o_i: o_i + 4 * n_i].view(torch.int32)
        self.out = b[o_out: o_out + math.prod(out_shape)].view(
            tuple(out_shape))
        self.fblob = self.fblob_t.numpy()
        self.iblob = self.iblob_t.numpy()


class _Buffer:
    """A kept byte buffer: the tensor, the offset of its first
    ALIGN-aligned byte, and the slots already cut from it, by layout (a
    bucket recurs, so its views are made once)."""

    __slots__ = ("t", "base", "slots")

    def __init__(self, t: torch.Tensor):
        self.t = t
        self.base = (-t.data_ptr()) % ALIGN
        self.slots: dict = {}

    def cap(self) -> int:
        return self.t.numel() - ALIGN


# the layouts a buffer keeps views for before it starts afresh
MAX_LAYOUTS = 64


class StagingPool:
    """The engine's kept slots: ``take`` one per chunk, ``release`` it in
    ``_finish``.  ``pinned`` allocates pinned memory (a failed allocation
    raises); ``keep`` bounds the free list (the stream's depth + 1).
    ``allocs`` counts the buffers allocated."""

    def __init__(self, pinned: bool, keep: int):
        self.pinned = pinned
        self.keep = keep
        self.size = 0              # every kept buffer's size in bytes
        self.allocs = 0
        self._free: list = []

    def take(self, n_f: int, n_i: int, out_shape) -> Slot:
        """A slot for blobs of ``n_f`` float64 and ``n_i`` int32 elements
        and a uint8 result of ``out_shape``; the buffers smaller than the
        largest slot asked for so far are dropped."""
        need = layout(n_f, n_i, out_shape)[3]
        if need > self.size:
            self.size = 1 << max(need - 1, 1).bit_length()
            self._free = [b for b in self._free if b.cap() >= self.size]
        if self._free:
            buf = self._free.pop()
        else:
            self.allocs += 1
            buf = _Buffer(torch.empty(self.size + ALIGN, dtype=torch.uint8,
                                      pin_memory=self.pinned))
        key = (n_f, n_i, tuple(out_shape))
        slot = buf.slots.get(key)
        if slot is None:
            if len(buf.slots) >= MAX_LAYOUTS:
                buf.slots.clear()
            slot = buf.slots[key] = Slot(buf, n_f, n_i, out_shape)
        return slot

    def release(self, slot: Slot) -> None:
        """Return ``slot``'s buffer: kept while it has the pool's size and
        fewer than ``keep`` are free, else dropped."""
        buf = slot.owner
        if buf.cap() >= self.size and len(self._free) < self.keep \
                and not any(b is buf for b in self._free):
            self._free.append(buf)
