"""Bitstream primitives: Annex-B NAL extraction, RBSP unescaping, and a
big-endian bit reader with Exp-Golomb decode.

Counterpart of the reference L0a layer
(/root/reference/Decoder/src/h264bsd_byte_stream.c:80 h264bsdExtractNalUnit,
h264bsd_stream.c:72 h264bsdGetBits, h264bsd_vlc.c:103
h264bsdDecodeExpGolombUnsigned). This stage is host-side by design: the
serial, branchy parse emits dense per-MB tensors consumed by the device
kernels (SURVEY.md §7 Stage A).
"""

from __future__ import annotations

from typing import Iterator, List, Tuple


class StreamError(Exception):
    pass


def split_nal_units(data: bytes) -> Iterator[Tuple[int, bytes]]:
    """Yield (byte_offset, escaped_nal_payload) for each Annex-B NAL.

    Accepts both 3- and 4-byte start codes; the payload excludes the start
    code and runs to the next start code (trailing zero bytes stripped).
    """
    import numpy as np
    n = len(data)
    a = np.frombuffer(data, np.uint8)
    # start code = ...00 00 01 (>=2 zeros then 1)
    if n >= 3:
        one = a[2:] == 1
        z2 = (a[1:-1] == 0) & (a[:-2] == 0)
        starts = (np.nonzero(one & z2)[0] + 3).tolist()
    else:
        starts = []
    for k, s in enumerate(starts):
        e = starts[k + 1] - 3 if k + 1 < len(starts) else n
        # the next start code may have been 4-byte: strip extra zeros
        while e > s and data[e - 1] == 0:
            e -= 1
        if e > s:
            yield s, data[s:e]


def unescape_rbsp(payload: bytes) -> bytes:
    """Strip emulation-prevention 0x03 bytes (inverse of spec 7.4.1.1)."""
    if b"\x00\x00\x03" not in payload:
        return payload
    import numpy as np
    a = np.frombuffer(payload, np.uint8)
    n = len(payload)
    # candidate EPB: 0x03 preceded by >= 2 zeros and followed by <= 3
    cand = np.zeros(n, bool)
    if n >= 3:
        c = ((a[2:] == 3) & (a[1:-1] == 0) & (a[:-2] == 0))
        nxt = np.ones(n - 2, bool)
        nxt[:-1] = a[3:] <= 3
        cand[2:] = c & nxt
    # spec: after an unescaped 03, the zero run restarts — consecutive
    # "00 00 03 00 00 03" is handled because the stripped 03 resets the
    # count only when actually removed. Candidates can't overlap (a
    # removed 03 sits between zeros), so positions are exact unless a
    # prior candidate was itself preceded by a removed 03 — impossible
    # since 03 != 00. Rare pathological "00 00 03 03" keeps only the
    # first 03 as EPB; the second 03 follows a non-zero so it is not a
    # candidate. Fall back to the scalar loop if candidates touch.
    idx = np.nonzero(cand)[0]
    if len(idx) >= 2 and (np.diff(idx) < 3).any():
        out = bytearray()
        zeros = 0
        i = 0
        while i < n:
            b = payload[i]
            if b == 3 and zeros >= 2 and i + 1 < n and payload[i + 1] <= 3:
                zeros = 0
                i += 1
                continue
            out.append(b)
            zeros = zeros + 1 if b == 0 else 0
            i += 1
        return bytes(out)
    return np.delete(a, idx).tobytes()


class BitReader:
    """MSB-first bit reader over an RBSP."""

    __slots__ = ("data", "pos", "nbits")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.pos = 0
        self.nbits = 8 * len(data)

    def u(self, n: int) -> int:
        p = self.pos
        if p + n > self.nbits:
            raise StreamError("end of stream")
        self.pos = p + n
        byte0 = p >> 3
        byte1 = (p + n - 1) >> 3
        acc = int.from_bytes(self.data[byte0 : byte1 + 1], "big")
        tail = 8 * (byte1 + 1) - (p + n)
        return (acc >> tail) & ((1 << n) - 1)

    def flag(self) -> bool:
        return bool(self.u(1))

    def peek(self, n: int) -> int:
        """Show up to n bits, zero-padded past the end (like
        h264bsdShowBits32)."""
        p, save = self.pos, self.pos
        avail = self.nbits - p
        if avail <= 0:
            return 0
        take = min(n, avail)
        v = self.u(take)
        self.pos = save
        return v << (n - take)

    def skip(self, n: int) -> None:
        if self.pos + n > self.nbits:
            raise StreamError("end of stream")
        self.pos += n

    def ue(self, max_bits: int = 32) -> int:
        lead = 0
        while not self.flag():
            lead += 1
            if lead > max_bits:
                raise StreamError("invalid exp-golomb code")
        if lead == 0:
            return 0
        return (1 << lead) - 1 + self.u(lead)

    def se(self) -> int:
        k = self.ue()
        if k & 1:
            return (k + 1) >> 1
        return -(k >> 1)

    def te(self, value_range: int) -> int:
        """`value_range` = number of possible values; 1-bit inverted form
        when only 0/1 are possible (spec 9.1.1)."""
        if value_range == 2:
            return 1 - self.u(1)
        return self.ue()

    def byte_aligned(self) -> bool:
        return self.pos % 8 == 0

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def read_bytes(self, n: int) -> bytes:
        assert self.byte_aligned()
        p = self.pos >> 3
        if (p + n) * 8 > self.nbits:
            raise StreamError("end of stream")
        self.pos += 8 * n
        return self.data[p : p + n]

    def more_rbsp_data(self) -> bool:
        """True if syntax elements remain before rbsp_trailing_bits
        (mirrors h264bsd_util.c:172 h264bsdMoreRbspData)."""
        bits_left = self.nbits - self.pos
        if bits_left <= 0:
            return False
        if bits_left > 8:
            return True
        # last byte: check for the trailing stop bit pattern 1 0...0
        tail = self.peek(bits_left) if bits_left else 0
        if tail == 0:
            return False
        # find lowest set bit among remaining
        low = tail & -tail
        return tail != low  # only the stop bit remains -> no more data

    def rbsp_trailing_bits(self) -> None:
        if not self.flag():
            raise StreamError("invalid rbsp_trailing_bits")
        while not self.byte_aligned():
            if self.flag():
                raise StreamError("invalid rbsp_trailing_bits")


class NalUnit:
    __slots__ = ("ref_idc", "nal_type", "rbsp")

    def __init__(self, payload: bytes) -> None:
        if not payload:
            raise StreamError("empty NAL")
        hdr = payload[0]
        if hdr & 0x80:
            raise StreamError("forbidden_zero_bit set")
        self.ref_idc = (hdr >> 5) & 3
        self.nal_type = hdr & 0x1F
        self.rbsp = unescape_rbsp(payload[1:])

    def __repr__(self) -> str:
        return f"NalUnit(type={self.nal_type}, ref_idc={self.ref_idc})"


NAL_SLICE = 1
NAL_SLICE_DPA = 2
NAL_SLICE_IDR = 5
NAL_SEI = 6
NAL_SPS = 7
NAL_PPS = 8
NAL_AUD = 9
NAL_END_OF_SEQ = 10
NAL_END_OF_STREAM = 11
NAL_FILLER = 12
