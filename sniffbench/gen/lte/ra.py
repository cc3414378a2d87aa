"""Resource-allocation math (36.213 7.1.6 / 8.1, 36.211 6.2.3.2).

Pure formula code (EXACT, no table reconstruction): RIV <-> (start, len),
type-0 RBG bitmaps, type-1 subsets, distributed-VRB mapping for format 1C,
and UL RIV with type-1/2 PUSCH frequency hopping.

Parity surface: srsRAN ra_dl/ra_ul usage plus the reference's own UL hopping
math (`lib/src/phy/falcon_phch/ul_sniffer_pusch.c:20-87`).
"""
from __future__ import annotations

import math




def riv_nbits(n_prb: int) -> int:
    return math.ceil(math.log2(n_prb * (n_prb + 1) / 2))


def start_len_to_riv(start: int, length: int, n_prb: int) -> int:
    if (length - 1) <= n_prb // 2:
        return n_prb * (length - 1) + start
    return n_prb * (n_prb - length + 1) + (n_prb - 1 - start)

