"""A Zstandard decoder (RFC 8878) in Python, with numpy for the Huffman
streams.

``decompress(data)`` decodes one or more frames in a row, skipping
skippable frames, and returns their concatenated content.  It handles every
block type (raw, RLE, compressed), every literals type (raw, RLE, Huffman
with direct or FSE-compressed weights in 1 or 4 streams, treeless), every
sequence table mode (predefined, RLE, FSE-compressed, repeat), the three
repeat offsets and back-references that overlap their own output.  It
verifies the frame's content size and, where the frame carries one, its
content checksum (the low 32 bits of XXH64).  Dictionaries are not
supported: a frame that names one raises.  A truncated or corrupt frame
raises ``ValueError``.

The checkpoints it reads are small (a config-4 model is 291 KB of array
data), so the decoder favours being plain over being fast: the literals'
Huffman streams are decoded by a table lookup at every bit position in numpy
followed by a walk along the chain of positions; the sequences by a loop.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

MAGIC = 0xFD2FB528
SKIPPABLE_MASK, SKIPPABLE_MAGIC = 0xFFFFFFF0, 0x184D2A50
BLOCK_MAX = 128 * 1024

# Literal-length and match-length codes: (baseline, extra bits), RFC 8878 3.1.1.3.2.1.1.
LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                             2048, 4096, 8192, 16384, 32768, 65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                                1027, 2051, 4099, 8195, 16387, 32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]

# Predefined distributions (RFC 8878 3.1.1.3.2.2): (counts, accuracy log).
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2,
               1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1,
               -1], 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
               -1, -1, -1], 5)
# (largest symbol, largest accuracy log) of each sequence table.
LL_MAX, ML_MAX, OF_MAX = (35, 9), (52, 9), (31, 8)
HUF_MAX_BITS = 11


# -- xxHash64, for the content checksum -------------------------------------------------

_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data`` (the reference algorithm, on Python integers)."""
    n, i = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64]
        lanes = np.frombuffer(data, "<u8", count=(n // 32) * 4).tolist()
        for j in range(0, len(lanes), 4):
            v[0] = _round(v[0], lanes[j])
            v[1] = _round(v[1], lanes[j + 1])
            v[2] = _round(v[2], lanes[j + 2])
            v[3] = _round(v[3], lanes[j + 3])
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for x in v:
            h = (((h ^ _round(0, x)) * _P1) + _P4) & _M64
        i = (n // 32) * 32
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _round(0, int.from_bytes(data[i:i + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= (int.from_bytes(data[i:i + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h ^= (data[i] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# -- bit streams ----------------------------------------------------------------------------

class _Backward:
    """A backward bit stream (RFC 8878 4.1): read from the last byte's
    highest set bit down to bit 0 of the first byte; each read takes the next
    ``n`` bits below the position as an integer, its first bit the most
    significant.  Reads past the start give zeros, and ``left`` goes negative."""

    __slots__ = ("buf", "pos")
    PAD = 8  # zero bytes in front of the stream

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ValueError("zstd: a bit stream must end in a byte with its end marker set")
        self.buf = bytes(self.PAD) + bytes(data) + bytes(8)
        self.pos = 8 * (self.PAD + len(data) - 1) + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos - n
        if p < 0:
            raise ValueError("zstd: a bit stream was read far past its start")
        self.pos = p
        return (int.from_bytes(self.buf[p >> 3:(p >> 3) + 5], "little") >> (p & 7)) & ((1 << n) - 1)

    @property
    def left(self) -> int:
        """Bits not yet read (negative once reads went past the start)."""
        return self.pos - 8 * self.PAD


def _forward_bits(data: bytes, pos: int, n: int) -> int:
    b = pos >> 3
    return (int.from_bytes(data[b:b + 4], "little") >> (pos & 7)) & ((1 << n) - 1)


# -- FSE ------------------------------------------------------------------------------------

class _Fse:
    """An FSE decoding table: for each state its symbol, the bits to read and
    the base the bits are added to (RFC 8878 4.1.1)."""

    __slots__ = ("log", "sym", "nb", "base")

    def __init__(self, counts: List[int], log: int):
        size = 1 << log
        sym = [0] * size
        high = size - 1
        nxt = [0] * len(counts)
        for s, c in enumerate(counts):
            if c == -1:
                sym[high] = s
                high -= 1
                nxt[s] = 1
            else:
                nxt[s] = c
        step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
        for s, c in enumerate(counts):
            for _ in range(max(c, 0)):
                sym[pos] = s
                pos = (pos + step) & mask
                while pos > high:
                    pos = (pos + step) & mask
        if pos != 0:
            raise ValueError("zstd: FSE distribution does not fill its table")
        nb, base = [0] * size, [0] * size
        for u in range(size):
            x = nxt[sym[u]]
            nxt[sym[u]] += 1
            nb[u] = log - (x.bit_length() - 1)
            base[u] = (x << nb[u]) - size
        self.log, self.sym, self.nb, self.base = log, sym, nb, base

    @classmethod
    def rle(cls, symbol: int) -> "_Fse":
        t = cls.__new__(cls)
        t.log, t.sym, t.nb, t.base = 0, [symbol], [0], [0]
        return t


def _read_counts(data: bytes, start: int, stop: int, max_symbol: int,
                 max_log: int) -> Tuple[List[int], int, int]:
    """The FSE table description at ``data[start:stop]`` (RFC 8878 4.1.1):
    the normalized counts, the accuracy log and the offset just past it."""
    pos, end = 8 * start, 8 * stop
    log = _forward_bits(data, pos, 4) + 5
    pos += 4
    if log > max_log:
        raise ValueError(f"zstd: FSE accuracy log {log} exceeds {max_log}")
    remaining, threshold, nbits = (1 << log) + 1, 1 << log, log + 1
    counts: List[int] = []
    prev0 = False
    while remaining > 1:
        if pos > end:
            raise ValueError("zstd: truncated FSE table description")
        if prev0:
            n0 = len(counts)
            while _forward_bits(data, pos, 16) == 0xFFFF:
                n0 += 24
                pos += 16
            while _forward_bits(data, pos, 2) == 3:
                n0 += 3
                pos += 2
            n0 += _forward_bits(data, pos, 2)
            pos += 2
            if n0 > max_symbol + 1:
                raise ValueError("zstd: FSE zero run past the largest symbol")
            counts += [0] * (n0 - len(counts))
        if len(counts) > max_symbol:
            raise ValueError("zstd: FSE table description past the largest symbol")
        most = (2 * threshold - 1) - remaining
        low = _forward_bits(data, pos, nbits - 1)
        if low < most:
            count = low
            pos += nbits - 1
        else:
            count = _forward_bits(data, pos, nbits)
            if count >= threshold:
                count -= most
            pos += nbits
        count -= 1
        remaining -= abs(count)
        counts.append(count)
        prev0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or pos > end:
        raise ValueError("zstd: corrupt FSE table description")
    return counts, log, (pos + 7) >> 3


# -- Huffman literals -------------------------------------------------------------------------

class _Huffman:
    """A Huffman decoding table indexed by the next ``bits`` bits of a stream."""

    __slots__ = ("bits", "sym", "nb")

    def __init__(self, weights: List[int]):
        total = sum(1 << (w - 1) for w in weights if w)
        if not total:
            raise ValueError("zstd: Huffman weights are all zero")
        bits = total.bit_length()  # highbit(total) + 1
        if bits > HUF_MAX_BITS:
            raise ValueError(f"zstd: Huffman code of {bits} bits")
        rest = (1 << bits) - total
        if rest & (rest - 1):
            raise ValueError("zstd: Huffman weights do not complete a power of 2")
        weights = list(weights) + [rest.bit_length()]
        if len(weights) > 256:
            raise ValueError("zstd: more than 256 Huffman symbols")
        rank = [0] * (bits + 2)
        for w in weights:
            rank[w] += 1
        start, nxt = 0, [0] * (bits + 2)
        for w in range(1, bits + 1):
            nxt[w] = start
            start += rank[w] << (w - 1)
        sym = np.zeros(1 << bits, np.uint8)
        nb = np.zeros(1 << bits, np.int64)
        for s, w in enumerate(weights):
            if w:
                n = 1 << (w - 1)
                sym[nxt[w]:nxt[w] + n] = s
                nb[nxt[w]:nxt[w] + n] = bits + 1 - w
                nxt[w] += n
        self.bits, self.sym, self.nb = bits, sym, nb

    def decode(self, stream: bytes, count: int) -> np.ndarray:
        """``count`` symbols of one stream; the stream must be used up exactly."""
        if not stream or stream[-1] == 0:
            raise ValueError("zstd: Huffman stream without its end marker")
        start = 8 * (len(stream) - 1) + stream[-1].bit_length() - 1
        # a little-endian u32 at every byte, 4 zero bytes in front for peeks below bit 0
        b = np.frombuffer(bytes(4) + stream + bytes(4), np.uint8).astype(np.int64)
        word = b[:-3] | (b[1:-2] << 8) | (b[2:-1] << 16) | (b[3:] << 24)
        pos = np.arange(start + 1)
        q = pos - self.bits + 32
        peek = (word[q >> 3] >> (q & 7)) & ((1 << self.bits) - 1)
        # -1 past the end: positions below 0 stay below 0, so the final check fails
        nxt = (pos - self.nb[peek]).tolist() + [-1] * (HUF_MAX_BITS + 1)
        visited = [0] * count
        p = start
        for i in range(count):
            visited[i] = p
            p = nxt[p]
        if p != 0:
            raise ValueError("zstd: Huffman stream not used up exactly")
        return self.sym[peek[visited]]


def _read_huffman(data: bytes, start: int, end: int) -> Tuple[_Huffman, int]:
    """The Huffman tree description at ``data[start:end]`` and its length."""
    if start >= end:
        raise ValueError("zstd: truncated Huffman tree description")
    head = data[start]
    if head >= 128:
        n = head - 127
        nbytes = (n + 1) // 2
        if start + 1 + nbytes > end:
            raise ValueError("zstd: truncated Huffman weights")
        raw = data[start + 1:start + 1 + nbytes]
        weights = [(raw[i // 2] >> (4 if i % 2 == 0 else 0)) & 15 for i in range(n)]
        return _Huffman(weights), 1 + nbytes
    if start + 1 + head > end:
        raise ValueError("zstd: truncated FSE-compressed Huffman weights")
    body = data[start + 1:start + 1 + head]
    counts, log, used = _read_counts(body, 0, len(body), 255, 6)
    table = _Fse(counts, log)
    bits = _Backward(body[used:])
    states = [bits.read(log), bits.read(log)]
    weights: List[int] = []
    me = 0
    while True:  # the two states take turns until a read runs past the start
        s = states[me]
        weights.append(table.sym[s])
        states[me] = table.base[s] + bits.read(table.nb[s])
        if bits.left < 0:
            weights.append(table.sym[states[1 - me]])
            break
        if len(weights) > 255:
            raise ValueError("zstd: too many Huffman weights")
        me ^= 1
    if any(w > HUF_MAX_BITS for w in weights):
        raise ValueError("zstd: Huffman weight too large")
    return _Huffman(weights), 1 + head


# -- frames and blocks --------------------------------------------------------------------------

class _FrameState:
    """What the blocks of one frame share: the previous Huffman table, the
    previous sequence tables and the three repeat offsets."""

    def __init__(self):
        self.huffman: Optional[_Huffman] = None
        self.tables: List[Optional[_Fse]] = [None, None, None]  # LL, OF, ML
        self.reps = [1, 4, 8]


def _literals(data: bytes, pos: int, end: int, st: _FrameState) -> Tuple[bytes, int]:
    if pos >= end:
        raise ValueError("zstd: truncated literals section")
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):  # raw, RLE
        head = (1, 2, 1, 3)[fmt]
        if pos + head > end:
            raise ValueError("zstd: truncated literals header")
        h = int.from_bytes(data[pos:pos + head], "little")
        size = h >> 3 if head == 1 else h >> 4
        pos += head
        if kind == 0:
            if pos + size > end:
                raise ValueError("zstd: truncated raw literals")
            return bytes(data[pos:pos + size]), pos + size
        if pos >= end:
            raise ValueError("zstd: truncated RLE literals")
        return bytes([data[pos]]) * size, pos + 1
    head, bits = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[fmt]
    if pos + head > end:
        raise ValueError("zstd: truncated literals header")
    h = int.from_bytes(data[pos:pos + head], "little")
    mask = (1 << bits) - 1
    size, csize = (h >> 4) & mask, (h >> (4 + bits)) & mask
    streams = 1 if fmt == 0 else 4
    pos += head
    if size > BLOCK_MAX or pos + csize > end:
        raise ValueError("zstd: corrupt compressed literals header")
    body_end = pos + csize
    if kind == 2:
        st.huffman, used = _read_huffman(data, pos, body_end)
        pos += used
    elif st.huffman is None:
        raise ValueError("zstd: treeless literals without an earlier Huffman table")
    table = st.huffman
    if streams == 1:
        out = table.decode(bytes(data[pos:body_end]), size)
    else:
        if pos + 6 > body_end:
            raise ValueError("zstd: truncated Huffman jump table")
        s1, s2, s3 = (int.from_bytes(data[pos + 2 * i:pos + 2 * i + 2], "little") for i in range(3))
        pos += 6
        per = (size + 3) // 4
        counts = [per, per, per, size - 3 * per]
        bounds = [pos, pos + s1, pos + s1 + s2, pos + s1 + s2 + s3, body_end]
        if counts[3] < 0 or bounds[3] > body_end:
            raise ValueError("zstd: corrupt Huffman jump table")
        out = np.concatenate([table.decode(bytes(data[bounds[i]:bounds[i + 1]]), counts[i])
                              for i in range(4)])
    return out.tobytes(), body_end


def _table(data: bytes, pos: int, end: int, mode: int, default, limits, prev) -> Tuple[_Fse, int]:
    if mode == 0:
        return _Fse(*default), pos
    if mode == 1:
        if pos >= end or data[pos] > limits[0]:
            raise ValueError("zstd: corrupt RLE sequence table")
        return _Fse.rle(data[pos]), pos + 1
    if mode == 2:
        counts, log, nxt = _read_counts(data, pos, end, *limits)
        return _Fse(counts, log), nxt
    if prev is None:
        raise ValueError("zstd: repeat-mode sequence table without an earlier table")
    return prev, pos


def _sequences(data: bytes, pos: int, end: int, lit: bytes, out: bytearray, st: _FrameState) -> None:
    if pos >= end:
        raise ValueError("zstd: truncated sequences section")
    b0 = data[pos]
    if b0 == 0:
        if pos + 1 != end:
            raise ValueError("zstd: bytes after an empty sequences section")
        out += lit
        return
    head = 1 if b0 < 128 else 2 if b0 < 255 else 3
    if pos + head >= end:
        raise ValueError("zstd: truncated sequences header")
    if b0 < 128:
        nseq = b0
    elif b0 < 255:
        nseq = ((b0 - 128) << 8) + data[pos + 1]
    else:
        nseq = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00
    pos += head
    modes = data[pos]
    pos += 1
    if modes & 3:
        raise ValueError("zstd: reserved bits set in the sequence modes")
    ll_t, pos = _table(data, pos, end, modes >> 6, LL_DEFAULT, LL_MAX, st.tables[0])
    of_t, pos = _table(data, pos, end, (modes >> 4) & 3, OF_DEFAULT, OF_MAX, st.tables[1])
    ml_t, pos = _table(data, pos, end, (modes >> 2) & 3, ML_DEFAULT, ML_MAX, st.tables[2])
    st.tables = [ll_t, of_t, ml_t]
    bits = _Backward(bytes(data[pos:end]))
    read = bits.read
    ll_s, of_s, ml_s = read(ll_t.log), read(of_t.log), read(ml_t.log)
    ll_sym, ll_nb, ll_base = ll_t.sym, ll_t.nb, ll_t.base
    of_sym, of_nb, of_base = of_t.sym, of_t.nb, of_t.base
    ml_sym, ml_nb, ml_base = ml_t.sym, ml_t.nb, ml_t.base
    r1, r2, r3 = st.reps
    lp = 0
    for i in range(nseq):
        of_code, ml_code, ll_code = of_sym[of_s], ml_sym[ml_s], ll_sym[ll_s]
        if of_code > 31 or ml_code > 52 or ll_code > 35:
            raise ValueError("zstd: sequence code out of range")
        ofv = (1 << of_code) + read(of_code)
        ml = ML_BASE[ml_code] + read(ML_BITS[ml_code])
        ll = LL_BASE[ll_code] + read(LL_BITS[ll_code])
        if ofv > 3:
            offset = ofv - 3
            r1, r2, r3 = offset, r1, r2
        else:
            idx = ofv + (ll == 0)
            if idx == 1:
                offset = r1
            elif idx == 2:
                offset = r2
                r1, r2 = r2, r1
            elif idx == 3:
                offset = r3
                r1, r2, r3 = r3, r1, r2
            else:
                offset = r1 - 1
                r1, r2, r3 = offset, r1, r2
        if i + 1 < nseq:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
        if lp + ll > len(lit):
            raise ValueError("zstd: a sequence takes more literals than the block has")
        out += lit[lp:lp + ll]
        lp += ll
        n = len(out)
        if offset < 1 or offset > n:
            raise ValueError(f"zstd: match offset {offset} outside the {n} bytes decoded")
        s = n - offset
        if offset >= ml:
            out += out[s:s + ml]
        else:
            out += (out[s:] * (ml // offset + 1))[:ml]
    if bits.left != 0:
        raise ValueError("zstd: sequences bit stream not used up exactly")
    st.reps = [r1, r2, r3]
    out += lit[lp:]


def _frame(data: bytes, pos: int, out: bytearray) -> int:
    """Decode the frame at ``data[pos:]`` (after its magic) onto ``out``;
    return the offset just past it."""
    n = len(data)
    if pos >= n:
        raise ValueError("zstd: truncated frame header")
    fhd = data[pos]
    pos += 1
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ValueError("zstd: reserved bit set in the frame header")
    if not single:
        if pos >= n:
            raise ValueError("zstd: truncated window descriptor")
        pos += 1
    dict_size = (0, 1, 2, 4)[dict_flag]
    if pos + dict_size > n:
        raise ValueError("zstd: truncated frame header")
    if int.from_bytes(data[pos:pos + dict_size], "little"):
        raise ValueError("zstd: frames that need a dictionary are not supported")
    pos += dict_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if pos + fcs_size > n:
        raise ValueError("zstd: truncated frame header")
    content_size = None
    if fcs_size:
        content_size = int.from_bytes(data[pos:pos + fcs_size], "little") + (256 if fcs_size == 2 else 0)
    pos += fcs_size
    st = _FrameState()
    frame_out = bytearray()
    while True:
        if pos + 3 > n:
            raise ValueError("zstd: truncated block header")
        h = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        if kind == 3:
            raise ValueError("zstd: reserved block type")
        if size > BLOCK_MAX:
            raise ValueError(f"zstd: block of {size} bytes")
        if kind == 1:
            if pos >= n:
                raise ValueError("zstd: truncated RLE block")
            frame_out += bytes([data[pos]]) * size
            pos += 1
        else:
            if pos + size > n:
                raise ValueError("zstd: truncated block")
            if kind == 0:
                frame_out += data[pos:pos + size]
            else:
                end = pos + size
                lit, p = _literals(data, pos, end, st)
                _sequences(data, p, end, lit, frame_out, st)
            pos += size
        if last:
            break
    if content_size is not None and len(frame_out) != content_size:
        raise ValueError(f"zstd: frame decoded to {len(frame_out)} bytes, header says "
                         f"{content_size}")
    if checksum:
        if pos + 4 > n:
            raise ValueError("zstd: truncated content checksum")
        want = int.from_bytes(data[pos:pos + 4], "little")
        if xxh64(bytes(frame_out)) & 0xFFFFFFFF != want:
            raise ValueError("zstd: content checksum mismatch")
        pos += 4
    out += frame_out
    return pos


def decompress(data: bytes) -> bytes:
    """The content of the zstd frames in ``data``, skippable frames skipped."""
    data = memoryview(data).tobytes()
    out = bytearray()
    pos, n = 0, len(data)
    if n == 0:
        raise ValueError("zstd: no frame in empty input")
    while pos < n:
        if pos + 4 > n:
            raise ValueError("zstd: truncated frame magic")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        pos += 4
        if magic == MAGIC:
            pos = _frame(data, pos, out)
        elif magic & SKIPPABLE_MASK == SKIPPABLE_MAGIC:
            if pos + 4 > n:
                raise ValueError("zstd: truncated skippable frame")
            size = int.from_bytes(data[pos:pos + 4], "little")
            if pos + 4 + size > n:
                raise ValueError("zstd: truncated skippable frame")
            pos += 4 + size
        else:
            raise ValueError(f"zstd: bad frame magic 0x{magic:08x}")
    return bytes(out)
