"""MAC-LTE pcap records (DLT 147, Wireshark's mac-lte framing): the bytes
a record of a downlink C-RNTI transport block must carry, and a reader of
a classic pcap file's record bodies.

Record body: radio type (1 = FDD), direction (1 = downlink), RNTI type
(3 = C-RNTI), then the tags 0x02 RNTI (2 bytes, big-endian), 0x03 UE id
(2), 0x04 SFN << 4 | subframe (2), 0x07 CRC status (1), 0x0a carrier id
(1), 0x0f NB-IoT mode (1), 0x01 and the MAC PDU to the end.
"""
from __future__ import annotations

import struct
from typing import List

DLT_MAC_LTE = 147


def dl_record(payload: bytes, rnti: int, sfn: int, sf: int) -> bytes:
    return (bytes([1, 1, 3, 0x02]) + struct.pack(">H", rnti)
            + bytes([0x03, 0, 0, 0x04])
            + struct.pack(">H", ((sfn & 0x3FF) << 4) | (sf & 0xF))
            + bytes([0x07, 1, 0x0A, 0, 0x0F, 0, 0x01]) + payload)


def read_bodies(path: str, offset: int = 24) -> List[bytes]:
    """Record bodies of a little-endian classic pcap from byte `offset` on
    (24, just past the global header, reads them all)."""
    with open(path, "rb") as f:
        head = f.read(24)
        magic, _, _, _, _, _, network = struct.unpack("<IHHiIII", head)
        if magic != 0xA1B2C3D4 or network != DLT_MAC_LTE:
            raise ValueError(f"{path}: not a little-endian DLT {DLT_MAC_LTE} "
                             f"pcap (magic {magic:#x}, network {network})")
        f.seek(offset)
        data = f.read()
    out, p = [], 0
    while p + 16 <= len(data):
        incl = struct.unpack("<I", data[p + 8:p + 12])[0]
        out.append(data[p + 16:p + 16 + incl])
        p += 16 + incl
    if p != len(data):
        raise ValueError(f"{path}: a record is cut off at byte {offset + p}")
    return out
