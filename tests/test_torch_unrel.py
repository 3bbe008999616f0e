"""The relaxation sweeps: the port's plain torch version (unrel_ref)
against the JAX package's ``unrel_sweeps2``, and the CUDA kernel's
warp body (csrc/unrel_row.cuh, built by g++ into
kernels.unrel_sweeps_host) against the plain version (more of that, and
the kernel on the card, in test_torch_unrel_shim.py).

Inputs: the sweeps' arguments of real chunks (tiny and a medium subset,
staged and packed by the port and run through its DP, demotions and
reconciliation on the CPU), and random planes made with numpy (NaN and
-inf log-probabilities, zero and huge counts, neighbour counts whose
R-binomial index runs past the log-factorial head, steps that do not
run).  Both implementations get the same numpy arrays.

Tolerance: against JAX, asgn equal on rows whose JAX margin is >= 1e-5
and finite margins within 1e-12 absolute, the inf and 1e-30 patterns
equal; the shim against the plain version bit for bit.
"""
import functools

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernel_shim import _load
from test_torch_rel import _jax_gm
from test_torch_unrel_shim import (SWEEP_CASES, _torch_pp, assert_bit_equal,
                                  random_sweep_inputs)

torch.set_num_threads(1)

EPS = 1e-5
TOL = 1e-12


@functools.lru_cache(maxsize=None)
def _jax_pp(fx: str):
    from classpro_tpu.tpu.device_pipeline import build_pipeline_params

    return build_pipeline_params(_jax_gm(fx))


def chunk_sweep_inputs(fx: str, n=None, B: int = 200):
    """The sweeps' arguments of every chunk of ``fx`` (CPU tensors)."""
    from classpro_tpu_torch import alldev
    from classpro_tpu_torch.engine import TorchEngine
    from classpro_tpu_torch.pack import pack_chunk

    gm, seqs, profs = _load(fx, n)
    eng = TorchEngine(gm, device="cpu")
    PP = _torch_pp(fx)
    out = []
    for lo in range(0, len(seqs), B):
        st = eng._stage(seqs[lo:lo + B], profs[lo:lo + B])
        slab, slot, n_out = st["slab"], st["slot"], st["n_out"]
        rows = [r for r in range(len(st["g"])) if n_out[r] > 0]
        ivs = [slab[r * slot: r * slot + int(n_out[r])]
               for r in range(len(st["g"]))]
        fb, ib, (Bn, max_n, R2, max_m), _ = pack_chunk(
            rows, ivs, [len(st["profiles"][i]) for i in st["g"]])
        U = alldev.unpack(torch.from_numpy(fb), torch.from_numpy(ib), Bn,
                          max_n, R2, max_m)
        rel2, _, _ = alldev.rel_pipeline(U, PP.rel, max_m, "ref")
        rel_out = alldev.reconcile_dev(rel2, U["m"], U["bcnt"], U["ecnt"],
                                       U["fwd"], R2 // 2, max_m)
        out.append(alldev.sweep_inputs(U, rel_out, PP.rel, Bn, max_n))
    return out


def _jax_sweeps(args, pp):
    from classpro_tpu.tpu.unrel_dev2 import unrel_sweeps2

    is_rel, asgn, P13, packL, packR, idx_d, idx_a, live, n = (
        jnp.asarray(a.numpy()) for a in args)
    a, mm = unrel_sweeps2(
        {"is_rel": is_rel, "asgn": asgn, "P13": P13, "packL": packL,
         "packR": packR}, {"idx": idx_d, "live": live},
        {"idx": idx_a, "live": live}, n, pp.unrel, max_n=asgn.shape[1])
    return np.asarray(a), np.asarray(mm)


def assert_close_to_jax(got, want):
    a_g, m_g = (x.numpy() for x in got)
    a_w, m_w = want
    ok = m_w >= EPS
    bad = np.nonzero((a_g != a_w).any(1) & ok)[0]
    assert bad.size == 0, ("asgn rows", bad[:10])
    assert (np.isinf(m_g) == np.isinf(m_w)).all()
    assert ((m_g == 1e-30) == (m_w == 1e-30)).all()
    fin = np.isfinite(m_g) & np.isfinite(m_w)
    assert np.abs(m_g[fin] - m_w[fin]).max(initial=0.0) <= TOL


@pytest.mark.parametrize("fx,n", [("tiny", None), ("medium", 200)])
def test_ref_and_shim_on_packs(fx, n):
    """Both against their yardsticks on real chunks."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.unrel_ref import unrel_sweeps_ref

    pp, PP = _jax_pp(fx), _torch_pp(fx)
    changed = 0
    for args in chunk_sweep_inputs(fx, n):
        want = unrel_sweeps_ref(*args, PP.unrel)
        assert_close_to_jax(want, _jax_sweeps(args, pp))
        assert_bit_equal(kernels.unrel_sweeps_host(*args, PP.unrel), want)
        changed += int((want[0].to(torch.int32) != args[1]).sum())
    assert changed > 0      # the sweeps decide the unreliable intervals


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_ref_and_shim_on_random_planes(seed):
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.unrel_ref import unrel_sweeps_ref

    pp, PP = _jax_pp("tiny"), _torch_pp("tiny")
    args = random_sweep_inputs(seed, PP.rel)
    # the planted extremes are there: NaN candidates, an R-binomial index
    # past the log-factorial head (clamped), huge and zero counts
    assert bool(torch.isnan(args[2]).any())
    assert int(args[4][..., 2].max()) * PP.unrel.dr_ratio \
        > PP.unrel.lf_small.numel()
    want = unrel_sweeps_ref(*args, PP.unrel)
    assert_close_to_jax(want, _jax_sweeps(args, pp))
    assert_bit_equal(kernels.unrel_sweeps_host(*args, PP.unrel), want)


@pytest.mark.parametrize("case", [c for c in SWEEP_CASES if c != "n1100"])
def test_ref_and_shim_on_sweep_layouts(case):
    """The plain version against JAX and the shim against the plain
    version on the warp layouts of test_torch_unrel_shim.SWEEP_CASES (the
    1100-column one against the plain version only, there).  A live step
    whose index lies outside [0, N) runs in JAX on a zero record and
    counts its margin; the port's contract leaves it out (chunks never
    hold one), so here such indices become N - 1, a step past n."""
    from classpro_tpu_torch import kernels
    from classpro_tpu_torch.unrel_ref import unrel_sweeps_ref

    pp, PP = _jax_pp("tiny"), _torch_pp("tiny")
    args = list(random_sweep_inputs(11 + SWEEP_CASES.index(case), PP.rel,
                                    case=case))
    N = args[1].shape[1]
    for k in (5, 6):
        args[k] = torch.where((args[k] < 0) | (args[k] >= N), N - 1, args[k])
    want = unrel_sweeps_ref(*args, PP.unrel)
    assert_close_to_jax(want, _jax_sweeps(args, pp))
    assert_bit_equal(kernels.unrel_sweeps_host(*args, PP.unrel), want)


def test_argmax_takes_the_first_nan_like_jax():
    from classpro_tpu_torch.unrel_ref import argmax4

    x = np.array([[0.0, 1.0, np.nan, 2.0], [np.nan, 1, 2, 3],
                  [1, np.inf, np.inf, 0], [-np.inf] * 4, [3, 1, 3, np.nan],
                  [2, 5, 5, 1]])
    np.testing.assert_array_equal(argmax4(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.argmax(x, axis=1)))


def test_unrel_params_carry_over_bit_equal():
    """unrel_params_from_numpy(the JAX UnrelParams2 as numpy) ==
    build_unrel_params(gm), field by field, sharing the DP's table."""
    from classpro_tpu_torch.params import (build_rel_params,
                                           build_unrel_params,
                                           unrel_params_from_numpy)

    gm, _, _ = _load("tiny", 1)
    rel = build_rel_params(gm, "cpu")
    u = _jax_pp("tiny").unrel
    d = {k: (np.asarray(v) if hasattr(v, "shape") else v)
         for k, v in u._asdict().items() if k != "ps"}
    got = unrel_params_from_numpy(d, rel)
    want = build_unrel_params(gm, rel)
    assert got.tab is rel.tab and want.tab is rel.tab
    assert torch.equal(got.btg_flat.view(torch.int64),
                       want.btg_flat.view(torch.int64))
    np.testing.assert_array_equal(np.asarray(u.lf_small), rel.lf_small)
    for f in ("n_cap", "read_len", "r_logp", "log_1m_pe_mean", "log_pe_mean",
              "dr_ratio", "cov_r", "cov_h", "cov_d"):
        a, b = getattr(got, f), getattr(want, f)
        assert type(a) is type(b) and a == b, f
