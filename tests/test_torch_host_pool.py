"""The host plane's kept worker pool (``pool::Pool`` in the port's
``csrc/host/classpro_host.cpp``) under the three entries that started and
joined their threads on every call before: the wall stage
(``cp_wall_stage_batch_ptr``), ``cp_finish_batch`` and
``cp_exact_rel_batch``, on medium's first 200 reads.

- Each entry writes the same bytes at T = 1, 2 and 8 as a first call at
  T = 1; again over 50 calls in a row at T = 8 (the workers and their
  thread_local workspaces kept between calls); from two Python threads
  calling at once (the pool runs one job at a time); and in a child
  forked after the pool started (a pool of its own there).
- The source: ``std::thread`` is constructed only inside the pool, and
  the batched entries nothing in the port calls (``cp_wall_stage_batch``,
  ``cp_unrel_batch``, ``cp_expand_batch``) are gone from the port's copy
  and its library, while the JAX package's ``csrc/classpro_host.cpp``
  keeps them.
Tolerance: byte equality.
"""
import pathlib
import re

import numpy as np
import pytest
import torch

from test_torch_kernel_shim import _load

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "classpro_tpu_torch" / "csrc" / "host" / "classpro_host.cpp"
ENTRIES = ("wall_stage", "finish_batch", "exact_rel_batch")
DEAD = ("cp_wall_stage_batch", "cp_unrel_batch", "cp_expand_batch")
N_EXACT = 60      # reads re-decided per exact_rel_batch call

_DATA: dict = {}


def _setup():
    """Medium's first 200 reads: the wall, the reads, a T = 1 wall slab
    (copied), a random rel_out for finish_batch and the class lines'
    offsets; made once per process."""
    if _DATA:
        return _DATA
    from classpro_tpu_torch.native import NativeWall

    gm, seqs, profs = _load("medium", 200)
    wall = NativeWall(gm)
    sq = [s.encode("ascii") for s in seqs]
    slab, n_out, n_rel, slot = wall.wall_stage_slab(sq, profs, threads=1)
    slab = slab[: len(sq) * slot].copy()
    live = np.flatnonzero(n_rel > 0)
    rng = np.random.default_rng(3)
    rel_out = rng.integers(0, 4, (live.size, int(n_rel.max())),
                           dtype=np.int8)
    out_off = np.zeros(len(sq) + 1, np.int64)
    out_off[1:] = np.cumsum([len(s) for s in sq])
    _DATA.update(wall=wall, sq=sq, profs=profs, slab=slab, slot=slot,
                 n_out=n_out, n_rel=n_rel, live=live, rel_out=rel_out,
                 out_off=out_off,
                 plens=np.array([len(p) for p in profs], np.int64))
    return _DATA


def run(entry: str, T: int) -> bytes:
    """One call of ``entry`` on the set-up's inputs at T workers: the bytes
    it wrote (the wall stage's live records and counts, the class lines,
    the re-decided rows)."""
    d = _setup()
    wall = d["wall"]
    if entry == "wall_stage":
        slab, n_out, n_rel, slot = wall.wall_stage_slab(d["sq"], d["profs"],
                                                        threads=T)
        recs = b"".join(slab[i * slot: i * slot + n].tobytes()
                        for i, n in enumerate(n_out))
        wall.release_slab(slab)
        return recs + n_out.tobytes() + n_rel.tobytes()
    if entry == "finish_batch":
        return wall.finish_batch(d["slab"], d["slot"], d["n_out"],
                                 d["n_rel"], d["rel_out"],
                                 d["rel_out"].shape[1], d["out_off"],
                                 threads=T).tobytes()
    live = d["live"][:N_EXACT]
    got = np.full((len(live), int(d["n_rel"].max())), -7, np.int8)
    wall.exact_rel_batch(d["slab"], d["slot"], d["n_out"], live,
                         d["plens"][live], got, np.arange(len(live)),
                         threads=T)
    return got.tobytes()


_REF: dict = {}


def _ref(entry: str) -> bytes:
    if entry not in _REF:
        _REF[entry] = run(entry, 1)
    return _REF[entry]


@pytest.mark.parametrize("T", [1, 2, 8])
@pytest.mark.parametrize("entry", ENTRIES)
def test_same_bytes_at_any_worker_count(entry, T):
    assert run(entry, T) == _ref(entry)


@pytest.mark.parametrize("entry", ENTRIES)
def test_fifty_calls_in_a_row(entry):
    want = _ref(entry)
    assert all(run(entry, 8) == want for _ in range(50))


@pytest.mark.parametrize("entry", ENTRIES)
def test_two_python_threads_at_once(entry):
    """Two Python threads call the entry at once (8 and 3 workers, a
    short switch interval): every call's bytes are the one-worker
    call's."""
    import sys
    import threading

    want = _ref(entry)
    results: list = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        ts = [threading.Thread(target=lambda T=T: results.extend(
            run(entry, T) == want for _ in range(6))) for T in (8, 3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert len(results) == 12 and all(results)


# a child forked after the pool started: run in a process of its own,
# without JAX's threads (os.fork in a process that holds them can hang)
_FORK = r"""
import os, sys
sys.path[:0] = sys.argv[1:3]
from test_torch_host_pool import ENTRIES, run
want = {e: run(e, 1) for e in ENTRIES}
assert all(run(e, 8) == want[e] for e in ENTRIES)
pid = os.fork()
if pid == 0:
    ok = False
    try:
        ok = all(run(e, T) == want[e] for e in ENTRIES for T in (8, 3))
    finally:
        os._exit(0 if ok else 1)
_, status = os.waitpid(pid, 0)
sys.exit(os.waitstatus_to_exitcode(status)
         or (0 if all(run(e, 8) == want[e] for e in ENTRIES) else 3))
"""


def test_entries_in_a_forked_child():
    import subprocess
    import sys

    tests = pathlib.Path(__file__).parent
    r = subprocess.run([sys.executable, "-c", _FORK, str(tests.parent),
                        str(tests)], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]


def _code(path: pathlib.Path) -> str:
    """The C++ source without its comments and string literals."""
    s = path.read_text()
    s = re.sub(r"//[^\n]*", "", s)
    s = re.sub(r"/\*.*?\*/", "", s, flags=re.S)
    return re.sub(r'"(?:\\.|[^"\\])*"', '""', s)


def test_threads_are_made_only_in_the_pool():
    code = _code(SRC)
    lo = code.index("namespace pool {")
    hi = code.index("namespace {", lo)        # the section after the pool
    uses = [m.start() for m in re.finditer(r"std::thread\b", code)]
    made = [p for p in uses
            if not code.startswith("std::thread::hardware_concurrency", p)]
    assert len(made) == 1 and lo < made[0] < hi, \
        [code[p - 40: p + 40] for p in made]
    assert code.startswith("new std::thread(", made[0] - 4)
    for word in ("std::async", "jthread", "pthread_create"):
        assert word not in code, word
    # every threaded entry runs on the pool
    for entry in ("cp_wall_stage_batch_ptr", "cp_finish_batch",
                  "cp_exact_rel_batch", "cp_pack_chunk", "cp_expand_rows",
                  "cp_demote_reconcile"):
        body = code[code.index(f" {entry}("):]
        body = body[: body.index("\n}\n")]
        assert "pool::parallel_rows(" in body, entry


def test_unused_batched_entries_are_gone():
    from classpro_tpu_torch.native import get_lib

    code, jax_code = _code(SRC), _code(ROOT / "csrc" / "classpro_host.cpp")
    lib = get_lib()
    for name in DEAD:
        assert not re.search(rf"\b{name}\s*\(", code), name
        assert re.search(rf"\b{name}\s*\(", jax_code), name
        assert not hasattr(lib, name), name
