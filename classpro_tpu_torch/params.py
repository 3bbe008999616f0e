"""Device-resident parameters of the reliable-interval DP.

``RelParams`` is the port's counterpart of the JAX package's
``RelOnlyParams`` (``PipelineParams.rel`` + ``.gcov``): the packed
Skellam table, the log-factorial tables, the model scalars and the global
coverages.  ``build_rel_params`` builds it from a ``GlobalModel``;
``rel_params_from_numpy`` carries a JAX parameter set over, given as
numpy arrays and Python scalars.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from classpro_tpu_torch.estimation import GlobalModel

REPEAT = 1


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
