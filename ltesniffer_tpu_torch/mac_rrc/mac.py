"""MAC PDU parsing/building (36.321 6.1/6.2).

DL-SCH / UL-SCH MAC PDUs (subheader chains, control elements, padding) and
Random Access Response PDUs.  Parity surface: srsRAN `sch_pdu` usage in the
reference (`src/src/DL_Sniffer_PDSCH.cc:1041-1070` C-RNTI PDU parse,
`:632-800` RAR unpack, `src/src/UL_Sniffer_PUSCH.cc:311-374`).

Builders are included so tests can synthesize eNB-side PDUs.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

# fixed-size MAC control elements: lcid -> body length
DL_CE_LEN = {28: 6, 29: 1, 30: 0, 31: 0}   # ConRes, TA, DRX, padding
UL_CE_LEN = {26: 1, 27: 2, 28: 1, 29: 1, 30: 3, 31: 0}  # PHR, C-RNTI, BSRs

LCID_CCCH = 0
LCID_CON_RES = 28
LCID_TA = 29
LCID_PADDING = 31
LCID_UL_CRNTI = 27


@dataclasses.dataclass
class MacSubPdu:
    lcid: int
    payload: bytes


def parse_mac_pdu(data: bytes, uplink: bool = False) -> List[MacSubPdu]:
    """Parse a DL-SCH/UL-SCH MAC PDU into sub-PDUs (SDUs + control elements)."""
    ce_len = UL_CE_LEN if uplink else DL_CE_LEN
    headers: List[Tuple[int, Optional[int]]] = []
    p = 0
    n = len(data)
    # --- subheader chain ---
    while p < n:
        octet = data[p]
        p += 1
        ext = (octet >> 5) & 1
        lcid = octet & 0x1F
        if lcid in ce_len:
            headers.append((lcid, ce_len[lcid]))
            if not ext:
                break
            continue
        if not ext:
            headers.append((lcid, None))   # last SDU: length implicit
            break
        # F/L field
        if p >= n:
            break
        f = (data[p] >> 7) & 1
        if f == 0:
            length = data[p] & 0x7F
            p += 1
        else:
            length = ((data[p] & 0x7F) << 8) | data[p + 1]
            p += 2
        headers.append((lcid, length))
    # --- payloads ---
    out = []
    for lcid, length in headers:
        if length is None:
            length = n - p
        body = data[p:p + length]
        p += length
        if lcid == LCID_PADDING:
            continue
        out.append(MacSubPdu(lcid=lcid, payload=body))
    return out


def build_mac_pdu(subs: List[MacSubPdu], uplink: bool = False,
                  pad_to: Optional[int] = None) -> bytes:
    """Build a MAC PDU (test-side).

    Without padding, the last SDU uses the implicit length form.  With
    ``pad_to``, every SDU gets an explicit length and a trailing padding
    subheader absorbs the remainder (the spec's 1/2-byte padding-first
    special cases are not needed for tests).
    """
    ce_len = UL_CE_LEN if uplink else DL_CE_LEN

    def emit(explicit_all: bool) -> bytes:
        hdr = bytearray()
        body = bytearray()
        for i, s in enumerate(subs):
            last = (i == len(subs) - 1) and not explicit_all
            if s.lcid in ce_len:
                hdr.append((0x00 if last else 0x20) | s.lcid)
            elif last:
                hdr.append(s.lcid)
            else:
                L = len(s.payload)
                hdr.append(0x20 | s.lcid)
                if L < 128:
                    hdr.append(L)
                else:
                    hdr.append(0x80 | (L >> 8))
                    hdr.append(L & 0xFF)
            body += s.payload
        if explicit_all:
            hdr.append(LCID_PADDING)
        return bytes(hdr) + bytes(body)

    if pad_to is None:
        return emit(False)
    pdu = emit(True)
    if len(pdu) > pad_to:
        raise ValueError("pad_to smaller than PDU")
    return pdu + b"\x00" * (pad_to - len(pdu))


# ---------------------------------------------------------------------------
# Random Access Response (36.321 6.1.5)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Rar:
    rapid: int
    ta: int
    grant: int         # 20-bit UL grant
    t_crnti: int


def parse_rar_pdu(data: bytes) -> Tuple[Optional[int], List[Rar]]:
    """Returns (backoff_indicator or None, list of RARs)."""
    p = 0
    rapids = []
    backoff = None
    while p < len(data):
        octet = data[p]
        p += 1
        ext = (octet >> 7) & 1
        t = (octet >> 6) & 1
        if t == 0:
            backoff = octet & 0x0F
        else:
            rapids.append(octet & 0x3F)
        if not ext:
            break
    rars = []
    for rapid in rapids:
        if p + 6 > len(data):
            break
        b = data[p:p + 6]
        p += 6
        ta = ((b[0] & 0x7F) << 4) | (b[1] >> 4)
        grant = ((b[1] & 0x0F) << 16) | (b[2] << 8) | b[3]
        t_crnti = (b[4] << 8) | b[5]
        rars.append(Rar(rapid=rapid, ta=ta, grant=grant, t_crnti=t_crnti))
    return backoff, rars


def build_rar_pdu(rars: List[Rar], backoff: Optional[int] = None) -> bytes:
    out = bytearray()
    heads = []
    if backoff is not None:
        heads.append(0x00 | (backoff & 0x0F))
    for r in rars:
        heads.append(0x40 | (r.rapid & 0x3F))
    for i, h in enumerate(heads):
        e = 0x80 if i < len(heads) - 1 else 0x00
        out.append(e | h)
    for r in rars:
        out.append((r.ta >> 4) & 0x7F)
        out.append(((r.ta & 0xF) << 4) | ((r.grant >> 16) & 0xF))
        out.append((r.grant >> 8) & 0xFF)
        out.append(r.grant & 0xFF)
        out.append((r.t_crnti >> 8) & 0xFF)
        out.append(r.t_crnti & 0xFF)
    return bytes(out)


def rar_grant_fields(grant: int) -> dict:
    """Unpack the 20-bit RAR UL grant (36.213 6.2).

    hopping(1) | rba(10) | trunc_mcs(4) | tpc(3) | ul_delay(1) | cqi_req(1)
    Matches `ul_sniffer_dci_rar_unpack` (`falcon_dci.c:648-657`).
    """
    return {
        "hopping": (grant >> 19) & 1,
        "rba": (grant >> 9) & 0x3FF,
        "trunc_mcs": (grant >> 5) & 0xF,
        "tpc": (grant >> 2) & 0x7,
        "ul_delay": (grant >> 1) & 1,
        "cqi_request": grant & 1,
    }


# ---------------------------------------------------------------------------
# RLC AM / PDCP SRB framing (36.322 6.2.1.4, 36.323 6.2.2)
# ---------------------------------------------------------------------------
def parse_rlc_am_data(pdu: bytes):
    """RLC AM data PDU -> payload after the header (None for control PDUs
    or re-segmented PDUs).  Handles the E=1 length-indicator extension.
    The reference parses these via srsRAN rlc_am
    (`UL_Sniffer_PUSCH.cc:311-374`)."""
    if len(pdu) < 2:
        return None
    b0 = pdu[0]
    if not (b0 & 0x80):         # D/C=0: control PDU (status)
        return None
    if b0 & 0x40:               # RF=1: AMD PDU segment — not reassembled
        return None
    e = (b0 >> 2) & 1
    p = 2
    if e:
        # length indicators: 12-bit LI + E bit each, padded to octets
        more = True
        nbits = 0
        while more:
            if 2 + (nbits + 12) // 8 >= len(pdu):
                return None     # the LI runs past the PDU
            li_bits = []
            for k in range(13):
                byte = pdu[2 + (nbits + k) // 8]
                li_bits.append((byte >> (7 - ((nbits + k) % 8))) & 1)
            more = li_bits[0] == 1
            nbits += 13
        p = 2 + (nbits + 7) // 8
    if p >= len(pdu):
        return None
    return pdu[p:]


def strip_pdcp_srb(sdu: bytes):
    """PDCP SRB data PDU -> RRC SDU: 1-byte header (5-bit SN) off the
    front, 4-byte MAC-I off the tail (36.323 6.2.2/6.3.4)."""
    if len(sdu) < 6:
        return None
    return sdu[1:-4]


def rlc_pdcp_rrc_sdu(mac_sdu: bytes):
    """DCCH MAC SDU -> RRC SDU candidates, best-guess first: full RLC AM +
    PDCP parse, then the MAC-I-less variant (truncated captures), then the
    raw SDU (transparent test paths)."""
    out = []
    am = parse_rlc_am_data(mac_sdu)
    if am is not None:
        if len(am) >= 6:
            out.append(am[1:-4])
        if len(am) >= 2:
            out.append(am[1:])
    out.append(mac_sdu)
    return out
