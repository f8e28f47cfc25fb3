"""Parcat: concatenate independently encoded bitstream chunks.

The PyTorch port's copy of the JAX package's apps/parcat.py (host code),
with one repair: the decoded-picture-hash SEIs take their picture's new
POC too.  The JAX app renumbers the slices only, so the hashes of every
chunk after the first name the first chunk's POCs, and a decoder checks
them against the wrong pictures (both packages' decoders report
MISMATCH there); here every MD5 of a spliced stream verifies.  Streams
without hash SEIs splice to the JAX app's bytes.

The analog of the reference Parcat (reference:
source/App/Parcat/parcat.cpp:393-427 — fixes POC numbering so chunks
encoded as separate jobs splice into one conformant stream; SURVEY.md §2.8
names this the practiced chunk-parallel encode strategy, which is exactly
how the multi-host GOP sharding merges its per-host outputs).

Usage:
  python -m vvc_mm_tpu_torch.apps.parcat out.bin chunk0.bin chunk1.bin ...
"""
from __future__ import annotations

import sys

from ..common.bitstream import (BitReader, BitWriter, NalUnit, read_annexb,
                                write_annexb, NAL_IDR, NAL_PPS, NAL_SEI,
                                NAL_SPS, NAL_TRAIL)
from ..common.slice_ps import SPS, SliceHeader


def splice(chunks: list[bytes]) -> bytes:
    """Concatenate Annex-B chunks, renumbering POCs to be continuous (in
    the slice headers and the MD5 hash SEIs).  The first chunk's SPS/PPS
    win; later parameter sets are dropped (they must match — chunks come
    from the same encode config)."""
    out: list[NalUnit] = []
    sps: SPS | None = None
    poc_offset = 0
    for ci, data in enumerate(chunks):
        max_poc = -1
        for nalu in read_annexb(data):
            if nalu.nal_type == NAL_SPS:
                if ci == 0:
                    sps = SPS.read(BitReader(nalu.payload))
                    out.append(nalu)
                continue
            if nalu.nal_type == NAL_PPS:
                if ci == 0:
                    out.append(nalu)
                continue
            if nalu.nal_type in (NAL_IDR, NAL_TRAIL):
                assert sps is not None, "chunk 0 must carry the SPS"
                br = BitReader(nalu.payload)
                sh = SliceHeader.read(br, sps)
                payload_rest = nalu.payload[br._pos // 8:]
                max_poc = max(max_poc, sh.poc)
                sh.poc += poc_offset
                sh.ref_pocs_l0 = [p + poc_offset for p in sh.ref_pocs_l0]
                sh.ref_pocs_l1 = [p + poc_offset for p in sh.ref_pocs_l1]
                bw = BitWriter()
                sh.write(bw, sps)
                out.append(NalUnit(nalu.nal_type, nalu.temporal_id,
                                   bw.get_bytes() + payload_rest))
            elif (nalu.nal_type == NAL_SEI and nalu.payload
                  and nalu.payload[0] == 0 and poc_offset):
                out.append(_hash_sei_moved(nalu, poc_offset))
            else:
                out.append(nalu)
        poc_offset += max_poc + 1
    return write_annexb(out)


def _hash_sei_moved(nalu: NalUnit, poc_offset: int) -> NalUnit:
    """A decoded-picture-hash SEI (payload type 0: POC, MD5) naming its
    picture's POC + poc_offset."""
    br = BitReader(nalu.payload)
    br.read(8)
    poc = br.read_uvlc()
    digest = [br.read(8) for _ in range(16)]
    bw = BitWriter()
    bw.write(0, 8)
    bw.write_uvlc(poc + poc_offset)
    for b in digest:
        bw.write(b, 8)
    bw.align()
    return NalUnit(nalu.nal_type, nalu.temporal_id, bw.get_bytes(),
                   nalu.layer_id)


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) < 3:
        raise SystemExit("usage: parcat out.bin chunk0.bin chunk1.bin ...")
    chunks = [open(p, "rb").read() for p in args[1:]]
    spliced = splice(chunks)
    with open(args[0], "wb") as f:
        f.write(spliced)
    print(f"spliced {len(args) - 1} chunks -> {args[0]} "
          f"({len(spliced)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
