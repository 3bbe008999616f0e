"""The port's per-chunk rel stage vs the JAX package's ``rel_only_dev``.

Both take the same C++ ``pack_rel`` blobs (staged by the port's engine on
the CPU) of chunks of the tiny fixture and a medium subset (tie8339 and
initkill21517: test_torch_rel_seeds.py; every branch/* fixture:
test_torch_branch*.py).  The port runs ``rel_only(..., impl="ref")`` on
the CPU; JAX runs ``rel_only_dev``'s body, with ``_rel_only_core``'s f64
margins, on its CPU backend.

Tolerance: asgn and rescue bit-equal on rows whose JAX margin is >= 1e-5;
risky equal except where |margin - 1e-5| < 1e-9; finite margins within
1e-9 absolute; the inf and 1e-30 margin patterns equal.
"""
import functools
import json
import pathlib

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest
import torch

from test_torch_kernel_shim import _load

FIX = pathlib.Path(__file__).parent / "fixtures"
EPS = 1e-5
TOL = 1e-9


@functools.lru_cache(maxsize=None)
def _jax_rel():
    """JAX rel_only_dev's body (_pack_out of _rel_only_core) in one
    program that also returns the core's f64 margins, so the DP compiles
    once per shape."""
    from classpro_tpu.tpu.device_pipeline import _pack_out, _rel_only_core

    @functools.partial(jax.jit, static_argnames=("R", "max_m"))
    def run(fb, ib, pp, R, max_m):
        core = _rel_only_core(fb, ib, pp, R, max_m)
        return core, _pack_out(*core, max_m)

    return run


def _jax_params(gm):
    """The JAX package's RelOnlyParams for ``gm``: the rel part of
    device_pipeline.build_pipeline_params (its unreliable-relaxation
    tables are not needed by rel_only_dev and cost seconds to build)."""
    import math

    import jax.numpy as jnp

    from classpro_tpu.numerics import LOGFACT
    from classpro_tpu.tpu.device_pipeline import RelOnlyParams
    from classpro_tpu.tpu.rel_dev2 import RelParams2
    from classpro_tpu.tpu.skellam_dev import (PackedSkellam,
                                              build_packed_skellam)

    tab, lf385 = build_packed_skellam()
    d = gm.defaults
    n1 = ((2 * int(gm.cov[1]) + 6 + 127) // 128) * 128
    rel = RelParams2(
        ps=PackedSkellam(tab=jnp.asarray(tab), lf_n=jnp.asarray(lf385)),
        logfact=jnp.asarray(LOGFACT), lf_small=jnp.asarray(LOGFACT[:n1]),
        read_len=float(gm.read_len), offset=d.offset, r_logp=d.r_logp,
        e_po_base=d.e_po_base, log_1m_pe_mean=math.log(1 - d.pe_mean),
        log_pe_mean=math.log(d.pe_mean), dr_ratio=gm.dr_ratio)
    return RelOnlyParams(rel=rel,
                         gcov=jnp.asarray(np.asarray(gm.cov, np.int64)))


def _jax_gm(fx: str):
    """The JAX package's own GlobalModel of a fixture."""
    from classpro_tpu.estimation import build_global_model
    from classpro_tpu.io.fastk import load_histogram

    d = FIX / fx
    args = {}
    if (d / "args.json").exists():
        args = json.loads((d / "args.json").read_text())
    model = str(d / "rand.model") if fx == "initkill21517" else None
    return build_global_model(load_histogram(str(d / "reads")),
                              model_path=model, **args)


def check_fixture(fx: str, n: int | None = None, B: int = 200,
                  eng=None) -> int:
    """Run every chunk of ``fx`` through both; returns rows compared."""
    from classpro_tpu_torch.engine import TorchEngine
    from classpro_tpu_torch.rel import (rel_only, rel_pipeline, rel_planes,
                                        unpack_out)

    gm, seqs, profs = _load(fx, n)
    if eng is None:
        eng = TorchEngine(gm, batch_size=B, device="cpu")
    pp = _jax_params(_jax_gm(fx))
    rows = 0
    for lo in range(0, len(seqs), B):
        pk = eng.stage_pack(seqs[lo:lo + B], profs[lo:lo + B])
        if pk is None:
            continue
        fb, ib, R, max_m = pk
        (j_asgn, j_mm, j_res), j_pack = _jax_rel()(fb, ib, pp, R=R,
                                                   max_m=max_m)
        j_asgn, j_mm, j_res = map(np.asarray, (j_asgn, j_mm, j_res))
        if fx == "tie8339":     # the jitted entry point itself, once
            from classpro_tpu.tpu.device_pipeline import rel_only_dev

            np.testing.assert_array_equal(
                np.asarray(rel_only_dev(fb, ib, pp, R=R, max_m=max_m)),
                np.asarray(j_pack))
        _, j_risky, _, _ = unpack_out(np.asarray(j_pack), max_m)

        tfb, tib = torch.from_numpy(fb), torch.from_numpy(ib)
        planes = rel_planes(tfb, tib, eng.P, R, max_m)
        asgn, mm, res = rel_pipeline(planes, eng.P, max_m, "ref")
        asgn, mm, res = asgn.to(torch.int8).numpy(), mm.numpy(), res.numpy()
        pack = rel_only(tfb, tib, eng.P, R, max_m, impl="ref").numpy()
        p_asgn, risky, p_res, _ = unpack_out(pack, max_m)
        np.testing.assert_array_equal(p_asgn, asgn)
        np.testing.assert_array_equal(p_res, res)

        ok = j_mm >= EPS
        bad = np.nonzero((asgn != j_asgn).any(1) & ok)[0]
        assert bad.size == 0, (fx, lo, "asgn rows", bad[:10])
        assert (res[ok] == j_res[ok]).all(), (fx, lo, "rescue")
        near = np.abs(j_mm - EPS) < TOL
        assert ((risky == j_risky) | near).all(), (fx, lo, "risky")
        assert (np.isinf(mm) == np.isinf(j_mm)).all(), (fx, lo, "inf")
        assert ((mm == 1e-30) == (j_mm == 1e-30)).all(), (fx, lo, "1e-30")
        fin = np.isfinite(mm) & np.isfinite(j_mm)
        assert np.abs(mm[fin] - j_mm[fin]).max(initial=0.0) <= TOL, (fx, lo)
        rows += len(mm)
    return rows


@pytest.mark.parametrize("fx,n", [("tiny", None), ("medium", 200)])
def test_rel_only_matches_jax(fx, n):
    assert check_fixture(fx, n) > 0


def test_rel_params_carry_over_bit_equal():
    """rel_params_from_numpy(the JAX parameter set as numpy) ==
    build_rel_params(gm), field by field, bit for bit."""
    from classpro_tpu_torch.params import build_rel_params, rel_params_from_numpy

    from classpro_tpu.tpu.device_pipeline import build_pipeline_params

    gm, _, _ = _load("tiny", 1)
    pp = build_pipeline_params(_jax_gm("tiny"))
    d = {k: (np.asarray(v) if hasattr(v, "shape") else v)
         for k, v in pp.rel._asdict().items() if k != "ps"}
    d["ps"] = {"tab": np.asarray(pp.rel.ps.tab),
               "lf_n": np.asarray(pp.rel.ps.lf_n)}
    d["gcov"] = np.asarray(pp.gcov)
    got = rel_params_from_numpy(d, "cpu")
    want = build_rel_params(gm, "cpu")
    for f in ("tab", "logfact", "lf_small", "gcov"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        if a.is_floating_point():
            assert torch.equal(a.view(torch.int64), b.view(torch.int64)), f
        else:
            assert torch.equal(a, b), f
    for f in ("read_len", "offset", "r_logp", "e_po_base", "log_1m_pe_mean",
              "log_pe_mean", "dr_ratio"):
        a, b = getattr(got, f), getattr(want, f)
        assert type(a) is type(b) and a == b, f
