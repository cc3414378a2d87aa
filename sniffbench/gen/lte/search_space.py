"""PDCCH search spaces (36.213 9.1.1) and blind-search location generation.

Behavioral parity with the reference's FALCON layer:
* `all_locations` — every CCE-aligned location at L=8,4,2,1 in generation
  order L=3..0 (matches `falcon_pdcch.c:321-356`
  `srsran_pdcch_ue_locations_all_map`, capped at 160 candidates / 84 CCEs);
* `validate_location` — 0 invalid / 1 valid-but-ambiguous / 2 valid, where
  "ambiguous" means the same ncce is also a candidate at L-1
  (`falcon_pdcch.c:223-250`);
* Yk recurrence with A=39827, D=65537 iterated sf_idx+1 times from the RNTI
  (`falcon_pdcch.c:57-60`).
"""
from __future__ import annotations

import functools
from typing import List, Tuple


from .params import RARNTI_START, RARNTI_END, CRNTI_START, CRNTI_END, MRNTI, SIRNTI

MAX_CANDIDATES_BLIND = 160
MAX_NUM_OF_CCE = 84
NOF_UE_CANDIDATES = (6, 6, 2, 2)  # per l = 0..3 (L = 1,2,4,8)


def yk(rnti: int, sf_idx: int) -> int:
    y = rnti
    for _ in range(sf_idx + 1):
        y = (39827 * y) % 65537
    return y


@functools.lru_cache(maxsize=16)
def all_locations(nof_cce: int) -> Tuple[Tuple[int, int], ...]:
    """All blind-search locations as (l, ncce), L=8 first (l=3..0)."""
    out = []
    n = min(nof_cce, MAX_NUM_OF_CCE)
    for l in range(3, -1, -1):
        L = 1 << l
        for i in range(n // L):
            if len(out) < MAX_CANDIDATES_BLIND:
                out.append((l, L * (i % (nof_cce // L))))
    return tuple(out)


def ue_candidates(rnti: int, sf_idx: int, nof_cce: int) -> List[Tuple[int, int]]:
    """UE-specific candidates (l, ncce) for all L, 36.213 Table 9.1.1-1."""
    y = yk(rnti, sf_idx)
    out = []
    for l in range(3, -1, -1):
        L = 1 << l
        if nof_cce < L:
            continue
        for i in range(NOF_UE_CANDIDATES[l]):
            ncce = L * ((y + i) % (nof_cce // L))
            if ncce + L <= nof_cce:
                out.append((l, ncce))
    return out


def common_candidates(nof_cce: int) -> List[Tuple[int, int]]:
    """Common search space: L=8 and L=4, first 16 CCEs."""
    out = []
    for l in (3, 2):
        L = 1 << l
        for i in range(min(nof_cce, 16) // L):
            ncce = L * (i % (nof_cce // L))
            if ncce + L <= nof_cce:
                out.append((l, ncce))
    return out


def candidates_for_rnti(rnti: int, sf_idx: int, nof_cce: int) -> List[Tuple[int, int]]:
    """Search space selection by RNTI class (`falcon_pdcch.c:180-210`)."""
    if RARNTI_START <= rnti <= RARNTI_END:
        return common_candidates(nof_cce)
    if CRNTI_START <= rnti <= CRNTI_END:
        return ue_candidates(rnti, sf_idx, nof_cce) + common_candidates(nof_cce)
    if MRNTI <= rnti <= SIRNTI:
        return common_candidates(nof_cce)
    return []  # reserved interval


def validate_location(nof_cce: int, ncce: int, l: int, sf_idx: int, rnti: int) -> int:
    """0 = invalid, 1 = valid but ambiguous with L-1, 2 = valid unambiguous."""
    ambiguous = False
    valid = False
    for (cl, cncce) in candidates_for_rnti(rnti, sf_idx, nof_cce):
        if cncce == ncce:
            if l > 0 and cl == l - 1:
                ambiguous = True
            if cl == l:
                valid = True
    if not valid:
        return 0
    return 1 if ambiguous else 2
