"""Shared enums and tuning constants.

Mirrors the reference's compile-time constant table (const.c:38-73 and
ClassPro.h:54-60) but exposes everything through a runtime config dataclass
so experiments do not require a rebuild (the reference requires
recompilation to change any of these).
"""

from __future__ import annotations

import dataclasses
import enum


class State(enum.IntEnum):
    """K-mer classification states (ClassPro.h:57)."""

    ERROR = 0
    REPEAT = 1
    HAPLO = 2
    DIPLO = 3


N_STATE = 4

# minimum decision margin below which a read's rel stage is recomputed
# on the host with exact arithmetic (the engine's exactness guard).  The
# risky comparison runs on the device, in f64; the shipped f32 margin is
# telemetry only.
REL_MARGIN_EPS = 1e-5

#: State -> output character (const.c:19)
STOC = "ERHD"

#: Output character -> state (const.c:21-36: 'D'->3,'H'->2,'R'->1, else 0)
CTOS = {"E": 0, "R": 1, "H": 2, "D": 3}


class Ctype(enum.IntEnum):
    """Low-complexity context types (ClassPro.h:58): homopolymer,
    dinucleotide satellite, trinucleotide satellite."""

    HP = 0
    DS = 1
    TS = 2


N_CTYPE = 3


class Etype(enum.IntEnum):
    """Error locus (ClassPro.h:59): error in this read (SELF) vs error in
    the other reads sharing the k-mer (OTHERS)."""

    SELF = 0
    OTHERS = 1


N_ETYPE = 2


class Wtype(enum.IntEnum):
    """Wall direction (ClassPro.h:60): count DROP vs count GAIN."""

    DROP = 0
    GAIN = 1


N_WTYPE = 2


class ThresT(enum.IntEnum):
    """Threshold stage (ClassPro.h:122)."""

    INIT = 0
    FINAL = 1


N_THRES = 2

#: Profile counts are 15-bit (const.c:38, libfastk.c:1512)
MAX_KMER_CNT = 32767


@dataclasses.dataclass(frozen=True)
class Defaults:
    """All tuning constants of the method (ref const.c:46-73).

    A single frozen instance is threaded through the pipeline; tests can
    construct variants without recompiling anything.
    """

    nthreads: int = 4                  # const.c:46 (host-side IO workers here)
    read_len: int = 20000              # const.c:47  `-r` READ_LEN
    max_read_len: int = 60000          # const.c:57 (FASTX inputs)
    n_sigma_rcov: int = 5              # const.c:58  R-cov = D + 5*sqrt(D)
    max_n_lc: int = 20                 # const.c:60  max bases in one LC event
    max_n_hc: int = 5                  # const.c:61  max bases in one HC event
    min_cnt_change: int = 3            # const.c:62
    max_cnt_change: int = 5            # const.c:63
    # PE_THRES[ThresT][Etype] (const.c:64)
    pe_thres_init_self: float = 0.001
    pe_thres_init_others: float = 0.05
    pe_thres_final_self: float = 1e-5
    pe_thres_final_others: float = 1e-5
    thres_diff_eo: float = -23.025851  # log(1e-10)  const.c:66
    thres_diff_rel: float = -9.210340  # log(1e-4)   const.c:67
    offset: int = 1000                 # const.c:69
    n_sigma_r: int = 2                 # const.c:70
    r_logp: float = -10.0              # const.c:71
    e_po_base: float = -10.0           # const.c:72
    pe_mean: float = 0.01              # const.c:73

    def pe_thres(self, thres_t: int, etype: int) -> float:
        return (
            (self.pe_thres_init_self, self.pe_thres_init_others),
            (self.pe_thres_final_self, self.pe_thres_final_others),
        )[thres_t][etype]


DEFAULTS = Defaults()
