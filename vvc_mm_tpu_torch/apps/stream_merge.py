"""StreamMergeApp analog: merge single-layer bitstreams into one

The PyTorch port's copy of the JAX package's apps/stream_merge.py (host code).
multi-layer stream.

Reference: source/App/StreamMergeApp (1,135 LoC) — interleaves the input
streams picture-by-picture, assigning each input a distinct nuh_layer_id.
The inverse operation is apps/bitstream_extractor.py.

Usage:
  python -m vvc_mm_tpu_torch.apps.stream_merge out.bin in0.bin in1.bin ...
"""
from __future__ import annotations

import sys

from ..common.bitstream import (NAL_IDR, NAL_TRAIL, NalUnit, read_annexb,
                                write_annexb)

_VCL = (NAL_IDR, NAL_TRAIL)


def merge(streams: list[bytes]) -> bytes:
    """Interleave access units of each stream, tagging layer ids."""
    per_layer: list[list[list[NalUnit]]] = []
    for li, data in enumerate(streams):
        aus: list[list[NalUnit]] = [[]]
        for n in read_annexb(data):
            n = NalUnit(n.nal_type, n.temporal_id, n.payload, li)
            aus[-1].append(n)
            if n.nal_type in _VCL:      # a VCL NAL ends the access unit
                aus.append([])
        if not aus[-1]:
            aus.pop()
        per_layer.append(aus)
    out: list[NalUnit] = []
    for au_idx in range(max(len(a) for a in per_layer)):
        for aus in per_layer:
            if au_idx < len(aus):
                out.extend(aus[au_idx])
    return write_annexb(out)


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) < 3:
        raise SystemExit("usage: stream_merge out.bin in0.bin in1.bin ...")
    streams = []
    for p in args[1:]:
        with open(p, "rb") as f:
            streams.append(f.read())
    out = merge(streams)
    with open(args[0], "wb") as f:
        f.write(out)
    print(f"merged {len(streams)} layers -> {args[0]} ({len(out)} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
