"""BitstreamExtractorApp analog: extract a layer / temporal sub-stream.

The PyTorch port's copy of the JAX package's apps/bitstream_extractor.py
(host code).

Reference: source/App/BitstreamExtractorApp (1,356 LoC) — OLS/subpicture
extraction; here: keep one nuh_layer_id and drop NAL units above a maximum
temporal id (the temporal-scalability use of the RA hierarchy's tids).

Usage:
  python -m vvc_mm_tpu_torch.apps.bitstream_extractor in.bin out.bin \
      [--layer=N] [--max-tid=T]
"""
from __future__ import annotations

import sys

from ..common.bitstream import NalUnit, read_annexb, write_annexb


def extract(data: bytes, layer: int = 0, max_tid: int = 7) -> bytes:
    out = []
    for n in read_annexb(data):
        if n.layer_id != layer:
            continue
        if n.temporal_id > max_tid:
            continue
        out.append(NalUnit(n.nal_type, n.temporal_id, n.payload, 0))
    return write_annexb(out)


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    layer, max_tid = 0, 7
    files = []
    for a in args:
        if a.startswith("--layer="):
            layer = int(a.split("=")[1])
        elif a.startswith("--max-tid="):
            max_tid = int(a.split("=")[1])
        else:
            files.append(a)
    if len(files) != 2:
        raise SystemExit("usage: bitstream_extractor in.bin out.bin "
                         "[--layer=N] [--max-tid=T]")
    with open(files[0], "rb") as f:
        data = f.read()
    out = extract(data, layer, max_tid)
    with open(files[1], "wb") as f:
        f.write(out)
    print(f"layer {layer}, tid<={max_tid}: {len(data)} -> {len(out)} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
