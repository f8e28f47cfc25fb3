"""Bitstream I/O: bit-level writer/reader, RBSP emulation prevention, NAL
framing.

TPU-native analog of the reference BitStream/NAL layer (reference:
source/Lib/CommonLib/BitStream.cpp, NAL.h, EncoderLib/NALwrite.cpp,
DecoderLib/NALread.cpp, AnnexBread.cpp).  Bitstream assembly is inherently
host-side and byte-oriented; it never touches the TPU.  Per-substream payloads
produced by the (parallel) entropy stage are concatenated deterministically
here (the Parcat pattern, reference: App/Parcat/parcat.cpp:393-427).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field


class BitWriter:
    """MSB-first bit writer with exp-Golomb helpers (reference:
    OutputBitstream, BitStream.cpp)."""

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._held = 0
        self._nheld = 0

    def write(self, value: int, nbits: int) -> None:
        assert 0 <= nbits <= 32 and 0 <= value < (1 << nbits), (value, nbits)
        self._held = (self._held << nbits) | value
        self._nheld += nbits
        while self._nheld >= 8:
            self._nheld -= 8
            self._bytes.append((self._held >> self._nheld) & 0xFF)
        self._held &= (1 << self._nheld) - 1

    def write_flag(self, flag: bool) -> None:
        self.write(1 if flag else 0, 1)

    def write_uvlc(self, value: int) -> None:
        """ue(v) exp-Golomb (reference: VLCWriter xWriteUvlc)."""
        assert value >= 0
        code = value + 1
        length = code.bit_length()
        self.write(0, length - 1)
        self.write(code, length)

    def write_svlc(self, value: int) -> None:
        """se(v) signed exp-Golomb."""
        self.write_uvlc(2 * value - 1 if value > 0 else -2 * value)

    def align(self, bit: int = 0) -> None:
        """rbsp_trailing_bits-style alignment: write a 1 then 0s (bit=1) or
        just pad (bit=0)."""
        if bit:
            self.write_flag(True)
        while self._nheld != 0:
            self.write_flag(False)

    def write_bytes(self, data: bytes) -> None:
        assert self._nheld == 0, "byte-align before writing raw bytes"
        self._bytes.extend(data)

    def get_bytes(self) -> bytes:
        assert self._nheld == 0, "unaligned bitstream"
        return bytes(self._bytes)

    def num_bits(self) -> int:
        return len(self._bytes) * 8 + self._nheld


class BitReader:
    """MSB-first bit reader (reference: InputBitstream)."""

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0       # bit position

    def read(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            byte = self._data[self._pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def read_flag(self) -> bool:
        return bool(self.read(1))

    def read_uvlc(self) -> int:
        zeros = 0
        while self.read(1) == 0:
            zeros += 1
            assert zeros <= 32, "corrupt uvlc"
        return ((1 << zeros) | self.read(zeros)) - 1 if zeros else 0

    def read_svlc(self) -> int:
        u = self.read_uvlc()
        return (u + 1) >> 1 if (u & 1) else -(u >> 1)

    def byte_align(self) -> None:
        self._pos = (self._pos + 7) & ~7

    def read_bytes(self, n: int) -> bytes:
        assert self._pos % 8 == 0
        start = self._pos >> 3
        self._pos += 8 * n
        return self._data[start:start + n]

    def bits_left(self) -> int:
        return len(self._data) * 8 - self._pos


# ---------------------------------------------------------------------------
# RBSP emulation prevention (reference: BitStream.cpp addEmulationPrevention /
# NALread.cpp convertPayloadToRBSP)
# ---------------------------------------------------------------------------
def add_emulation_prevention(rbsp: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def remove_emulation_prevention(payload: bytes) -> bytes:
    out = bytearray()
    zeros = 0
    i = 0
    n = len(payload)
    while i < n:
        b = payload[i]
        if zeros >= 2 and b == 3 and i + 1 < n and payload[i + 1] <= 3:
            zeros = 0
            i += 1
            continue
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


# ---------------------------------------------------------------------------
# NAL framing. We use VVC-style NAL unit types for the structural roles we
# need (reference: NAL.h NalUnitType); Annex-B start codes 00 00 00 01.
# ---------------------------------------------------------------------------
NAL_IDR = 8            # IDR_N_LP-like
NAL_TRAIL = 1          # trailing picture
NAL_SPS = 15
NAL_PPS = 16
NAL_PH = 17
NAL_SEI = 23

START_CODE = b"\x00\x00\x00\x01"


@dataclass
class NalUnit:
    nal_type: int
    temporal_id: int
    payload: bytes      # RBSP (pre emulation prevention)
    layer_id: int = 0   # nuh_layer_id analog (multi-layer streams,
                        # reference: StreamMergeApp assigns these)


def write_annexb(nalus: list[NalUnit]) -> bytes:
    """Serialize NAL units with start codes + 2-byte VVC-style header."""
    out = bytearray()
    for nalu in nalus:
        out += START_CODE
        # header: forbidden_zero(1) reserved(1) layer_id(6) | type(5) tid+1(3)
        out.append(nalu.layer_id & 0x3F)
        out.append(((nalu.nal_type & 0x1F) << 3) | ((nalu.temporal_id + 1) & 7))
        # rbsp-stop byte: payloads may legally end in 0x00 (alignment or
        # range-coder output), which would be eaten by start-code zero
        # stripping — terminate with 0x80 like rbsp_trailing_bits.
        out += add_emulation_prevention(nalu.payload + b"\x80")
    return bytes(out)


def read_annexb(data: bytes) -> list[NalUnit]:
    """Parse an Annex-B stream into NAL units (reference: AnnexBread.cpp)."""
    nalus = []
    i = 0
    n = len(data)
    starts = []
    while i < n - 2:
        if data[i] == 0 and data[i + 1] == 0 and data[i + 2] == 1:
            starts.append(i + 3)
            i += 3
        else:
            i += 1
    starts.append(None)
    for s, e in zip(starts[:-1], starts[1:]):
        end = (e - 3) if e is not None else n
        while end > s and data[end - 1] == 0:   # trailing zeros of next SC
            end -= 1
        hdr1 = data[s + 1]
        nal_type = (hdr1 >> 3) & 0x1F
        tid = (hdr1 & 7) - 1
        layer_id = data[s] & 0x3F
        payload = remove_emulation_prevention(data[s + 2:end])
        # strip the rbsp-stop byte (see write_annexb)
        assert payload and payload[-1] == 0x80, "missing rbsp stop byte"
        nalus.append(NalUnit(nal_type, tid, payload[:-1], layer_id))
    return nalus
