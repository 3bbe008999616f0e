"""The stream's kept host staging (``staging.StagingPool``) and the
packers writing into it, on the CPU.

- The pool: every view of a slot 256-byte aligned and of its dtype and
  shape; a released slot taken again; a slot too small for a chunk
  replaced, never resized, the smaller ones dropped; at most ``keep``
  free; a slot never released never handed out again.
- ``NativeWall.pack_rel`` and ``NativeWall.pack_chunk`` writing into a
  slot pre-filled with 0xA5 bytes, or with NaNs, equal a fresh pack bit
  for bit (``fblob`` as uint64), on the tiny and every branch/* chunk,
  ``pack_chunk`` at T = 1 and 8; a wrong dtype, a short, a
  non-contiguous or a read-only destination raises ValueError.
- ``TorchEngine.classify_stream`` on the CPU, both paths, with the
  pool's release filling the slot with garbage before it frees it:
  the bytes equal the goldens (tiny and branch/*), so no view of a slot
  is read after its release; every slot of the run is released.
Tolerance: bit and byte equality.
"""
import gzip
import pathlib

import numpy as np
import pytest
import torch

from test_torch_kernel_shim import _load

torch.set_num_threads(1)

FIX = pathlib.Path(__file__).parent / "fixtures"
BRANCH = sorted(p.name for p in (FIX / "branch").iterdir() if p.is_dir())
NAMES = ["tiny"] + [f"branch/{b}" for b in BRANCH]
ALIGN = 256

_DATA: dict = {}


def _dataset(name: str):
    if name not in _DATA:
        _DATA[name] = _load(name)
    return _DATA[name]


def _pool(keep: int = 4):
    from classpro_tpu_torch.staging import StagingPool

    return StagingPool(False, keep)


def _aligned(a) -> bool:
    ptr = a.data_ptr() if isinstance(a, torch.Tensor) else a.ctypes.data
    return ptr % ALIGN == 0


# ------------------------------------------------------------------ pool
@pytest.mark.parametrize("n_f,n_i,out_shape", [
    (1, 1, (1, 1)), (33, 7, (3, 5)), (256 * 128, 4 * 256 * 128 + 512,
                                      (512, 133)),
    (5 * 256 * 192 + 3 * 512 * 128, 1000, (256, 193))])
def test_take_views(n_f, n_i, out_shape):
    s = _pool().take(n_f, n_i, out_shape)
    assert s.fblob.dtype == np.float64 and s.fblob.shape == (n_f,)
    assert s.iblob.dtype == np.int32 and s.iblob.shape == (n_i,)
    assert s.out.dtype == torch.uint8 and tuple(s.out.shape) == out_shape
    for v in (s.fblob, s.iblob, s.fblob_t, s.iblob_t, s.out):
        assert _aligned(v)
    # the numpy and torch views are the same memory, and the three views
    # do not overlap
    assert s.fblob.ctypes.data == s.fblob_t.data_ptr()
    assert s.iblob.ctypes.data == s.iblob_t.data_ptr()
    assert s.fblob.ctypes.data + 8 * n_f <= s.iblob.ctypes.data
    assert s.iblob.ctypes.data + 4 * n_i <= s.out.data_ptr()
    end = s.out.data_ptr() + s.out.numel()
    assert end <= s.buf.data_ptr() + s.buf.numel()
    s.fblob[:] = 1.5
    s.iblob[:] = -7
    s.out.fill_(9)
    assert (s.fblob == 1.5).all() and (s.iblob == -7).all()
    assert bool((s.out == 9).all())


def test_release_then_take_reuses():
    pool = _pool()
    a = pool.take(100, 100, (4, 4))
    buf = a.buf
    pool.release(a)
    assert len(pool._free) == 1
    b = pool.take(90, 120, (2, 8))       # fits the same buffer
    assert b.buf is buf and pool.allocs == 1 and len(pool._free) == 0


def test_growth_replaces_the_small_slots():
    pool = _pool()
    small = [pool.take(10, 10, (1, 1)) for _ in range(3)]
    for s in small:
        pool.release(s)
    assert len(pool._free) == 3 and pool.allocs == 3
    big = pool.take(100000, 10, (1, 1))
    assert len(pool._free) == 0                     # the small ones dropped
    assert all(big.buf is not s.buf for s in small)
    assert big.buf.numel() - ALIGN >= pool.size >= 8 * 100000
    # a slot in flight from before the growth is dropped at its release
    pool2 = _pool()
    old = pool2.take(10, 10, (1, 1))
    pool2.release(pool2.take(100000, 10, (1, 1)))
    pool2.release(old)
    assert len(pool2._free) == 1
    s = pool2.take(10, 10, (1, 1))
    assert s.buf.numel() - ALIGN >= pool2.size
    pool2.release(s)
    # once the largest chunk is met, no take allocates
    n = pool2.allocs
    for _ in range(5):
        pool2.release(pool2.take(50000, 50000, (100, 100)))
    assert pool2.allocs == n


def test_free_list_is_bounded():
    pool = _pool(keep=2)
    slots = [pool.take(10, 10, (1, 1)) for _ in range(5)]
    for s in slots:
        pool.release(s)
    assert len(pool._free) == 2
    pool.release(slots[0])                     # released twice: kept once
    assert len(pool._free) == 2


def test_a_dropped_slot_is_not_handed_out_again():
    pool = _pool()
    dropped = pool.take(10, 10, (1, 1))         # never released
    kept = pool.take(10, 10, (1, 1))
    pool.release(kept)
    got = [pool.take(10, 10, (1, 1)) for _ in range(3)]
    assert all(g.buf is not dropped.buf for g in got)
    assert got[0].buf is kept.buf


@pytest.mark.gpu
def test_pinned_slots_on_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from classpro_tpu_torch.staging import StagingPool

    s = StagingPool(True, 4).take(1000, 1000, (10, 10))
    assert s.buf.is_pinned() and s.out.is_pinned()
    assert s.fblob_t.is_pinned() and s.iblob_t.is_pinned()


# --------------------------------------------------------------- packers
def _staged(wall, seqs, profs, B=200):
    """Each chunk as ``TorchEngine._stage`` stages it: (slab, slot, n_out,
    n_rel, plens, rows)."""
    for lo in range(0, len(seqs), B):
        S, P = seqs[lo:lo + B], profs[lo:lo + B]
        g = sorted((i for i in range(len(S)) if len(P[i])),
                   key=lambda i: len(P[i]))
        if not g:
            continue
        slab, n_out, n_rel, slot = wall.wall_stage_slab(
            [S[i].encode("ascii") for i in g], [P[i] for i in g], threads=2)
        yield (slab, slot, n_out, n_rel,
               np.array([len(P[i]) for i in g], np.int64),
               np.flatnonzero(n_out > 0).astype(np.int32))


def _dirty(slot, fill: str):
    """The slot's buffer filled with 0xA5 bytes or with NaNs."""
    if fill == "a5":
        slot.buf.fill_(0xA5)
    else:
        n = slot.buf.numel() // 8 * 8
        slot.buf[:n].view(torch.float64).fill_(float("nan"))
    return slot


def _same(got, want):
    fb, ib = got
    wfb, wib = want
    assert fb.dtype == wfb.dtype == np.float64 and fb.shape == wfb.shape
    assert ib.dtype == wib.dtype == np.int32
    np.testing.assert_array_equal(ib, wib)
    np.testing.assert_array_equal(fb.view(np.uint64), wfb.view(np.uint64))


@pytest.mark.parametrize("name", NAMES)
def test_packers_write_a_dirty_slot_whole(name):
    from classpro_tpu_torch import alldev, rel
    from classpro_tpu_torch.engine import _bucket_m
    from classpro_tpu_torch.native import NativeWall, chunk_dims
    from classpro_tpu_torch.pack import _bucket

    gm, seqs, profs = _dataset(name)
    wall = NativeWall(gm)
    pool = _pool()
    seen = 0
    for slab, slot, n_out, n_rel, plens, rows in _staged(wall, seqs, profs):
        sel = int((n_rel > 0).sum())
        if sel:
            R, M = _bucket(sel), _bucket_m(int(n_rel.max()))
            want = wall.pack_rel(slab, slot, n_out, n_rel, plens, R, M)
            for fill in ("a5", "nan"):
                s = _dirty(pool.take(*rel.blob_sizes(R, M), (2 * R, M + 5)),
                           fill)
                got = wall.pack_rel(slab, slot, n_out, n_rel, plens, R, M,
                                    fblob=s.fblob, iblob=s.iblob)
                assert got[0].ctypes.data == s.fblob.ctypes.data
                _same(got, want)
                _same((s.fblob, s.iblob), want)
                pool.release(s)
                seen += 1
        if rows.size:
            dims = chunk_dims(n_out, n_rel, rows)
            fb, ib, wdims = wall.pack_chunk(slab, slot, n_out, n_rel, plens,
                                            rows, threads=1)
            assert wdims == dims
            for T in (1, 8):
                for fill in ("a5", "nan"):
                    s = _dirty(pool.take(*alldev.blob_sizes(*dims),
                                         (dims[0], dims[1] + 1)), fill)
                    got = wall.pack_chunk(slab, slot, n_out, n_rel, plens,
                                          rows, threads=T, fblob=s.fblob,
                                          iblob=s.iblob)
                    assert got[2] == dims
                    _same(got[:2], (fb, ib))
                    _same((s.fblob, s.iblob), (fb, ib))
                    pool.release(s)
                    seen += 1
    assert seen


def _tiny_chunk():
    from classpro_tpu_torch.native import NativeWall

    gm, seqs, profs = _dataset("tiny")
    wall = NativeWall(gm)
    return wall, next(_staged(wall, seqs, profs))


def _bad(kind: str, n: int, dtype):
    if kind == "dtype":
        return np.empty(n, np.float32 if dtype == np.float64 else np.int64)
    if kind == "short":
        return np.empty(n - 1, dtype)
    if kind == "noncontig":
        return np.empty(2 * n, dtype)[::2]
    a = np.empty(n, dtype)
    a.flags.writeable = False
    return a


@pytest.mark.parametrize("packer", ["pack_rel", "pack_chunk"])
@pytest.mark.parametrize("kind", ["dtype", "short", "noncontig", "readonly"])
def test_a_bad_destination_raises(packer, kind):
    from classpro_tpu_torch import alldev, rel
    from classpro_tpu_torch.engine import _bucket_m
    from classpro_tpu_torch.native import chunk_dims
    from classpro_tpu_torch.pack import _bucket

    wall, (slab, slot, n_out, n_rel, plens, rows) = _tiny_chunk()
    if packer == "pack_rel":
        R, M = _bucket(int((n_rel > 0).sum())), _bucket_m(int(n_rel.max()))
        n_f, n_i = rel.blob_sizes(R, M)
        call = lambda **kw: wall.pack_rel(slab, slot, n_out, n_rel,  # noqa
                                          plens, R, M, **kw)
    else:
        n_f, n_i = alldev.blob_sizes(*chunk_dims(n_out, n_rel, rows))
        call = lambda **kw: wall.pack_chunk(slab, slot, n_out, n_rel,  # noqa
                                            plens, rows, **kw)
    good_f, good_i = np.empty(n_f, np.float64), np.empty(n_i, np.int32)
    call(fblob=good_f, iblob=good_i)                  # the good pair packs
    with pytest.raises(ValueError, match="fblob"):
        call(fblob=_bad(kind, n_f, np.float64), iblob=good_i)
    with pytest.raises(ValueError, match="iblob"):
        call(fblob=good_f, iblob=_bad(kind, n_i, np.int32))


# ---------------------------------------------------------------- engine
def _golden(name: str, n: int) -> list[str]:
    text = gzip.decompress((FIX / name / "golden.class.gz").read_bytes())
    return text.decode().splitlines()[3::4][:n]


@pytest.mark.parametrize("alldev", [False, True], ids=["main", "alldev"])
@pytest.mark.parametrize("name", ["tiny", "branch"])
def test_a_slot_released_with_garbage_changes_no_byte(name, alldev,
                                                      monkeypatch):
    """The stream on the CPU with every released slot overwritten by
    garbage (alternately 0xA5 bytes and NaNs) before the pool keeps it:
    still the golden bytes, and every slot taken was released."""
    from classpro_tpu_torch.engine import TorchEngine
    from classpro_tpu_torch.staging import StagingPool

    orig_take, orig_release = StagingPool.take, StagingPool.release
    taken, released = [], []

    def take(self, *a):
        s = orig_take(self, *a)
        taken.append(s)
        return s

    def release(self, slot):
        _dirty(slot, "a5" if len(released) % 2 else "nan")
        released.append(slot)
        orig_release(self, slot)

    monkeypatch.setattr(StagingPool, "take", take)
    monkeypatch.setattr(StagingPool, "release", release)
    names = ["tiny"] if name == "tiny" else [f"branch/{b}" for b in BRANCH]
    reused = False
    for fx in names:
        gm, seqs, profs = _dataset(fx)
        B = 32
        eng = TorchEngine(gm, batch_size=B, device="cpu", alldev=alldev)
        assert not eng.staging.pinned
        chunks = [(seqs[lo:lo + B], profs[lo:lo + B])
                  for lo in range(0, len(seqs), B)]
        del taken[:], released[:]
        got = [c for out in eng.classify_stream(iter(chunks), sort_window=8)
               for c in out]
        assert got == _golden(fx, len(seqs)), fx
        assert len(released) == len(taken)
        reused |= eng.staging.allocs < len(taken)
    # on tiny (seven chunks) dirty slots were packed into; a branch set's
    # chunks rise in size through its one sort window, so each grows
    assert reused or name != "tiny"
