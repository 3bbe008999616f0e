"""Device-resident parameters of the DP and of the relaxation sweeps.

``RelParams`` is the port's counterpart of the JAX package's
``RelOnlyParams`` (``PipelineParams.rel`` + ``.gcov``): the packed
Skellam table, the log-factorial tables, the model scalars and the global
coverages.  ``UnrelParams`` is the counterpart of ``UnrelParams2`` (the
relaxation sweeps' binomial tails and scalars); it shares the packed
table and ``lf_small`` with a ``RelParams``, so the 94.6 MB table sits on
the device once.  ``PipelineParams`` holds both, for the all-device path.
``build_*`` build them from a ``GlobalModel``; ``*_from_numpy`` carry a
JAX parameter set over, given as numpy arrays and Python scalars.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from classpro_tpu_torch.estimation import GlobalModel

REPEAT, HAPLO, DIPLO = 1, 2, 3


@dataclasses.dataclass
class RelParams:
    tab: torch.Tensor        # (385, 6144, 5) f64 packed Skellam table
    logfact: torch.Tensor    # (32768,) f64
    lf_small: torch.Tensor   # (n1,) f64 logfact head, n1 covers 2*cov_R+6
    read_len: float
    offset: int
    r_logp: float
    e_po_base: float
    log_1m_pe_mean: float
    log_pe_mean: float
    dr_ratio: float
    gcov: torch.Tensor       # (4,) int64 global coverages (E, R, H, D)

    @property
    def device(self) -> torch.device:
        return self.tab.device


def _f64(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float64), device=device)


def build_rel_params(gm: GlobalModel, device) -> RelParams:
    """RelParams for ``gm`` on ``device`` (device_pipeline.
    build_pipeline_params, rel part)."""
    from classpro_tpu_torch.numerics import LOGFACT
    from classpro_tpu_torch.skellam import build_packed_skellam

    tab, _lf385 = build_packed_skellam()
    d = gm.defaults
    cov_r = int(gm.cov[REPEAT])
    n1 = ((2 * cov_r + 6 + 127) // 128) * 128   # covers strc and DR*dl
    return RelParams(
        tab=_f64(tab, device), logfact=_f64(LOGFACT, device),
        lf_small=_f64(LOGFACT[:n1], device),
        read_len=float(gm.read_len), offset=int(d.offset),
        r_logp=float(d.r_logp), e_po_base=float(d.e_po_base),
        log_1m_pe_mean=math.log(1 - d.pe_mean),
        log_pe_mean=math.log(d.pe_mean), dr_ratio=float(gm.dr_ratio),
        gcov=torch.tensor(np.asarray(gm.cov, np.int64), device=device))


def rel_params_from_numpy(d: dict, device) -> RelParams:
    """Carry a JAX ``RelOnlyParams`` over: ``d`` holds the fields of
    ``.rel`` (``RelParams2``) as numpy arrays / Python scalars, with
    ``d["ps"]`` = {"tab": ..., "lf_n": ...}, plus ``d["gcov"]``."""
    return RelParams(
        tab=_f64(d["ps"]["tab"], device), logfact=_f64(d["logfact"], device),
        lf_small=_f64(d["lf_small"], device),
        read_len=float(d["read_len"]), offset=int(d["offset"]),
        r_logp=float(d["r_logp"]), e_po_base=float(d["e_po_base"]),
        log_1m_pe_mean=float(d["log_1m_pe_mean"]),
        log_pe_mean=float(d["log_pe_mean"]), dr_ratio=float(d["dr_ratio"]),
        gcov=torch.tensor(np.asarray(d["gcov"], np.int64), device=device))


@dataclasses.dataclass
class UnrelParams:
    tab: torch.Tensor        # the RelParams' packed Skellam table
    lf_small: torch.Tensor   # the RelParams' logfact head
    btg_flat: torch.Tensor   # (n_cap*n_cap,) f64 log binomial tail, erate 0.1
    n_cap: int
    read_len: float
    r_logp: float
    log_1m_pe_mean: float
    log_pe_mean: float
    dr_ratio: float
    cov_r: int
    cov_h: int
    cov_d: int

    @property
    def device(self) -> torch.device:
        return self.tab.device


@dataclasses.dataclass
class PipelineParams:
    """The all-device path's parameters (device_pipeline.PipelineParams;
    the global coverages live in ``rel.gcov``)."""
    rel: RelParams
    unrel: UnrelParams


def build_unrel_params(gm: GlobalModel, rel: RelParams) -> UnrelParams:
    """UnrelParams for ``gm`` on ``rel``'s device, sharing its table
    (device_pipeline.build_pipeline_params, unrel part)."""
    from classpro_tpu_torch.tables import build_tables

    dt = build_tables(gm)
    d = gm.defaults
    return UnrelParams(
        tab=rel.tab, lf_small=rel.lf_small,
        btg_flat=_f64(dt.btg_log()[dt.unrel_idx].reshape(-1), rel.device),
        n_cap=int(dt.n_cap), read_len=float(gm.read_len),
        r_logp=float(d.r_logp), log_1m_pe_mean=math.log(1 - d.pe_mean),
        log_pe_mean=math.log(d.pe_mean), dr_ratio=float(gm.dr_ratio),
        cov_r=int(gm.cov[REPEAT]), cov_h=int(gm.cov[HAPLO]),
        cov_d=int(gm.cov[DIPLO]))


def build_pipeline_params(gm: GlobalModel, device) -> PipelineParams:
    rel = build_rel_params(gm, device)
    return PipelineParams(rel=rel, unrel=build_unrel_params(gm, rel))


def build_replicas(gm: GlobalModel, devices, alldev: bool) -> dict:
    """One replica of the tables per distinct device of ``devices`` (a
    list that may repeat a device), keyed by ``canonical_device``: the
    ``PipelineParams`` when ``alldev``, else the ``RelParams``.  Each
    replica holds the 94.6 MB Skellam table, as the JAX mesh replicates
    it on every device."""
    from classpro_tpu_torch.device import canonical_device

    build = build_pipeline_params if alldev else build_rel_params
    return {d: build(gm, d)
            for d in dict.fromkeys(canonical_device(x) for x in devices)}


def unrel_params_from_numpy(d: dict, rel: RelParams) -> UnrelParams:
    """Carry a JAX ``UnrelParams2`` over: ``d`` holds its fields as numpy
    arrays / Python scalars (``ps`` and ``lf_small`` are taken from
    ``rel``, which carried the same arrays over)."""
    return UnrelParams(
        tab=rel.tab, lf_small=rel.lf_small,
        btg_flat=_f64(d["btg_flat"], rel.device), n_cap=int(d["n_cap"]),
        read_len=float(d["read_len"]), r_logp=float(d["r_logp"]),
        log_1m_pe_mean=float(d["log_1m_pe_mean"]),
        log_pe_mean=float(d["log_pe_mean"]), dr_ratio=float(d["dr_ratio"]),
        cov_r=int(d["cov_r"]), cov_h=int(d["cov_h"]), cov_d=int(d["cov_d"]))
