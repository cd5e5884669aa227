"""The port's zstd decoder (``mmtraj_torch/orbax_io/zstd.py``) against
frames that tensorstore's zstd writes, and against hand-made frames.

Tensorstore compresses a zarr v2 chunk in a ``memory://`` store, so the
frames come from the same library (and settings) that writes an Orbax
checkpoint's chunks; no other zstd package is needed.  Every frame must
decode to its input byte for byte.  A truncated or corrupted frame raises
``ValueError``, and with a content checksum no single-bit flip decodes to
other bytes.
"""

import numpy as np
import pytest
import tensorstore as ts

from mmtraj_torch.orbax_io import zstd

KIB = 1024
SIZES = [1, 100, 128 * KIB - 1, 128 * KIB, 128 * KIB + 1, 1024 * KIB]
LEVELS = [1, 3, 9, 19]
TEXT = b"".join(b"line %d: the pedestrian at (%d, %d) walks %s.\n"
                % (i, i % 97, i % 13, b"north" if i % 3 else b"east") for i in range(40000))


def _payload(kind: str, n: int) -> bytes:
    rng = np.random.default_rng(n)
    if kind == "zeros":
        return bytes(n)
    if kind == "random":
        return rng.bytes(n)
    if kind == "normal":
        return rng.normal(size=(n + 3) // 4).astype(np.float32).tobytes()[:n]
    if kind == "skewed":  # few matches, Huffman-coded literals in 4 streams
        return np.minimum(rng.geometric(0.15, size=n), 255).astype(np.uint8).tobytes()
    return (TEXT * (n // len(TEXT) + 1))[:n]


def ts_frame(payload: bytes, level: int) -> bytes:
    """The zstd frame tensorstore writes for ``payload`` as one zarr chunk."""
    n = len(payload)
    arr = ts.open({"driver": "zarr", "kvstore": "memory://",
                   "metadata": {"shape": [n], "chunks": [n], "dtype": "|u1",
                                "compressor": {"id": "zstd", "level": level}},
                   "create": True}).result()
    arr[...] = np.frombuffer(payload, np.uint8)
    return arr.kvstore.read(b"0").result().value


def _checksummed(frame: bytes, content: bytes) -> bytes:
    """``frame`` with its content checksum flag set and the checksum appended."""
    b = bytearray(frame)
    assert not b[4] & 4
    b[4] |= 4
    return bytes(b) + (zstd.xxh64(content) & 0xFFFFFFFF).to_bytes(4, "little")


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind", ["zeros", "random", "normal", "text"])
def test_decodes_tensorstore_frames(kind, size, level):
    payload = _payload(kind, size)
    assert zstd.decompress(ts_frame(payload, level)) == payload


@pytest.mark.parametrize("level", [1, 19])
def test_source_text_reaches_every_table_mode(level):
    """Varied text over several blocks: FSE-compressed and repeat-mode
    sequence tables, treeless literals and repeat offsets."""
    rng = np.random.default_rng(level)
    words = [bytes(rng.integers(97, 123, size=rng.integers(2, 9)).astype(np.uint8))
             for _ in range(300)]
    payload = b" ".join(words[i] for i in rng.integers(0, 300, size=120000))
    assert zstd.decompress(ts_frame(payload, level)) == payload


def test_xxh64_vectors():
    assert zstd.xxh64(b"") == 0xEF46DB3751D8E999
    assert zstd.xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert zstd.xxh64(b"abc") == 0x44BC2CF5AD770999


MAGIC = zstd.MAGIC.to_bytes(4, "little")
EMPTY = MAGIC + bytes([0x20, 0x00, 0x01, 0x00, 0x00])  # single segment, size 0, last raw block of 0
# single segment, size 300 (2-byte field: 300 - 256), one last RLE block of 300 bytes of 'x'
RLE = MAGIC + bytes([0x60, 44, 0x00]) + (300 << 3 | 0b011).to_bytes(3, "little") + b"x"
RAW = MAGIC + bytes([0x20, 5]) + (5 << 3 | 1).to_bytes(3, "little") + b"hello"


def test_hand_made_frames():
    assert zstd.decompress(EMPTY) == b""
    assert zstd.decompress(RLE) == b"x" * 300
    assert zstd.decompress(RAW) == b"hello"
    skippable = (0x184D2A53).to_bytes(4, "little") + (7).to_bytes(4, "little") + b"skipped"
    assert zstd.decompress(skippable + RAW) == b"hello"
    assert zstd.decompress(RAW + RLE + skippable + EMPTY) == b"hello" + b"x" * 300


def test_content_checksum():
    # empty content: the checksum is the low 32 bits of xxh64(b"") = 0x51D8E999
    empty = MAGIC + bytes([0x24, 0x00, 0x01, 0x00, 0x00, 0x99, 0xE9, 0xD8, 0x51])
    assert zstd.decompress(empty) == b""
    payload = _payload("text", 5000)
    frame = _checksummed(ts_frame(payload, 3), payload)
    assert zstd.decompress(frame) == payload
    for bad in (empty[:-1] + b"\x52", frame[:-1] + bytes([frame[-1] ^ 1])):
        with pytest.raises(ValueError, match="checksum"):
            zstd.decompress(bad)


def test_content_size_mismatch_raises():
    wrong = bytearray(RAW)
    wrong[5] = 6
    with pytest.raises(ValueError, match="header says 6"):
        zstd.decompress(bytes(wrong))


@pytest.mark.parametrize("kind", ["text", "normal", "skewed"])
def test_every_truncation_raises(kind):
    frame = ts_frame(_payload(kind, 3000), 3)
    for cut in range(len(frame)):
        with pytest.raises(ValueError):
            zstd.decompress(frame[:cut])


@pytest.mark.parametrize("kind, size", [("text", 2000), ("skewed", 600)])
def test_bit_flips_raise_or_decode_the_same(kind, size):
    """With a content checksum, flipping any one bit either raises
    ``ValueError`` or leaves the content as it was (a flag that does not
    change it, such as the window size)."""
    payload = _payload(kind, size)
    frame = _checksummed(ts_frame(payload, 3), payload)
    raised = 0
    for i in range(len(frame)):
        for bit in range(8):
            b = bytearray(frame)
            b[i] ^= 1 << bit
            try:
                assert zstd.decompress(bytes(b)) == payload, (i, bit)
            except ValueError:
                raised += 1
    assert raised >= 7 * len(frame)


@pytest.mark.parametrize("frame, match", [
    (b"", "empty input"),
    (b"\x28\xb5\x2f", "truncated frame magic"),
    (b"\x00\x00\x00\x00" + RAW[4:], "bad frame magic"),
    (MAGIC + bytes([0x28]) + RAW[5:], "reserved bit"),
    (MAGIC + bytes([0x21, 1, 5]) + RAW[6:], "dictionary"),
    (MAGIC + bytes([0x20, 0]) + (0b111).to_bytes(3, "little"), "reserved block type"),
    (MAGIC + bytes([0x00, 0x08]) + ((128 * KIB + 1) << 3 | 1).to_bytes(3, "little"), "block of"),
    ((0x184D2A50).to_bytes(4, "little") + (9).to_bytes(4, "little") + b"short", "skippable"),
])
def test_malformed_frames_raise(frame, match):
    with pytest.raises(ValueError, match=match):
        zstd.decompress(frame)
