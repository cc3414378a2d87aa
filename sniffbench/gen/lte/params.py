"""LTE dimensioning and cell configuration (36.211).

Pure-Python static parameters.  Everything here is *static* (shapes are fixed
once a cell config is chosen) so that the whole per-subframe pipeline can be
traced and compiled once by XLA.

Reference behavior being matched (not copied): the cell struct handling in the
reference app (`src/src/LTESniffer_Core.cc:240-247` presets cell from CLI in
file mode; `src/include/Settings.h:44-50` defaults 50 PRB / 2 ports / 1 rx ant).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# FFT size / sampling rate per downlink bandwidth (N_RB_DL).
_FFT_BY_PRB = {6: 128, 15: 256, 25: 512, 50: 1024, 75: 1536, 100: 2048}

N_SC_RB = 12          # subcarriers per resource block
N_SYM_SF = 14         # OFDM symbols per subframe (normal CP)
N_SYM_SLOT = 7        # OFDM symbols per slot (normal CP)
SF_PER_FRAME = 10
N_RB_MAX = 110        # 36.211: max DL bandwidth in RB (CRS sequence length basis)

SIRNTI = 0xFFFF
PRNTI = 0xFFFE
MRNTI = 0xFFFD
RARNTI_START = 0x0001
RARNTI_END = 0x003C
CRNTI_START = 0x003D
CRNTI_END = 0xFFF3


def fft_size(n_rb: int) -> int:
    return _FFT_BY_PRB[n_rb]


def sample_rate(n_rb: int) -> float:
    """Sample rate in Hz for the standard power-of-two FFT sizes."""
    return 15000.0 * fft_size(n_rb)


def cp_lengths(n_fft: int) -> Tuple[int, ...]:
    """Normal-CP lengths (samples) for the 7 symbols of one slot."""
    first = 160 * n_fft // 2048
    rest = 144 * n_fft // 2048
    return (first,) + (rest,) * 6


def slot_samples(n_fft: int) -> int:
    return sum(cp_lengths(n_fft)) + 7 * n_fft


def sf_samples(n_fft: int) -> int:
    return 2 * slot_samples(n_fft)


@dataclasses.dataclass(frozen=True)
class CellConfig:
    """Static cell configuration.  Frozen → usable as a jit static argument."""

    n_id_cell: int            # physical cell id 0..503
    n_prb: int = 50           # downlink bandwidth in PRB
    nof_ports: int = 2        # number of eNB CRS antenna ports (1, 2 or 4)
    nof_rx_ant: int = 1       # receiver antennas
    phich_resources: float = 1.0   # Ng: 1/6, 1/2, 1, 2 (from MIB)
    phich_length: int = 0     # 0 = normal, 1 = extended

    def __post_init__(self):
        if self.n_prb not in _FFT_BY_PRB:
            raise ValueError(f"unsupported bandwidth: {self.n_prb} PRB")
        if not 0 <= self.n_id_cell <= 503:
            raise ValueError(f"invalid cell id {self.n_id_cell}")
        if self.nof_ports not in (1, 2, 4):
            raise ValueError(f"invalid port count {self.nof_ports}")

    # --- derived dimensioning -------------------------------------------
    @property
    def n_fft(self) -> int:
        return fft_size(self.n_prb)

    @property
    def n_sc(self) -> int:
        return self.n_prb * N_SC_RB

    @property
    def srate(self) -> float:
        return sample_rate(self.n_prb)

    @property
    def sf_len(self) -> int:
        return sf_samples(self.n_fft)

    @property
    def n_id_1(self) -> int:
        return self.n_id_cell // 3

    @property
    def n_id_2(self) -> int:
        return self.n_id_cell % 3

    @property
    def vshift(self) -> int:
        return self.n_id_cell % 6

    @property
    def nof_phich_groups(self) -> int:
        """36.211 6.9: N^group_PHICH = ceil(Ng * N_RB / 8) for FDD normal CP."""
        import math
        return int(math.ceil(self.phich_resources * self.n_prb / 8.0))

    def nof_cce(self, cfi: int) -> int:
        """Number of CCEs in the control region for a given CFI."""
        return nof_cce(self, cfi)


def nof_regs_in_symbol(cell: CellConfig, l: int) -> int:
    """REGs per OFDM symbol in the control region (36.211 6.2.4)."""
    if l == 0:
        return 2 * cell.n_prb
    if l == 1:
        return (2 if cell.nof_ports == 4 else 3) * cell.n_prb
    return 3 * cell.n_prb


def nof_ctrl_regs(cell: CellConfig, cfi: int) -> int:
    return sum(nof_regs_in_symbol(cell, l) for l in range(cfi))


def nof_pdcch_regs(cell: CellConfig, cfi: int) -> int:
    """REGs available to PDCCH = control REGs - PCFICH(4) - PHICH groups(3 each)."""
    return nof_ctrl_regs(cell, cfi) - 4 - 3 * cell.nof_phich_groups


def nof_cce(cell: CellConfig, cfi: int) -> int:
    return nof_pdcch_regs(cell, cfi) // 9
