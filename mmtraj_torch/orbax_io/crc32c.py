"""CRC-32C (Castagnoli), the checksum in the footer of every OCDBT manifest
and node file, from a 256-entry table."""

from __future__ import annotations

_POLY = 0x82F63B78  # the Castagnoli polynomial, bit-reflected


def _table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _table()


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C of ``data``, continuing from ``crc``."""
    crc ^= 0xFFFFFFFF
    table = _TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def verify_footer(data: bytes, name: str) -> None:
    """Check the little-endian CRC-32C in the last 4 bytes of ``data``
    against the bytes before it; a mismatch raises ``ValueError`` naming
    ``name``."""
    if len(data) < 4:
        raise ValueError(f"{name}: too short to hold a CRC-32C footer ({len(data)} bytes)")
    want = int.from_bytes(data[-4:], "little")
    got = crc32c(data[:-4])
    if got != want:
        raise ValueError(f"{name}: CRC-32C checksum mismatch (footer 0x{want:08x}, "
                         f"content 0x{got:08x})")
