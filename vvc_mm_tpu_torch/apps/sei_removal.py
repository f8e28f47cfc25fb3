"""SEIRemovalApp analog: strip SEI NAL units from a bitstream.

The PyTorch port's copy of the JAX package's apps/sei_removal.py (host code).

Reference: source/App/SEIRemovalApp (538 LoC) — drops SEI messages (all of
them, or keeping the decoded-picture-hash) so streams can be compared or
shrunk; here one pass over the NAL list.

Usage:
  python -m vvc_mm_tpu_torch.apps.sei_removal in.bin out.bin [--keep-hash]
"""
from __future__ import annotations

import sys

from ..common.bitstream import NAL_SEI, read_annexb, write_annexb


def remove_sei(data: bytes, keep_hash: bool = False) -> bytes:
    nalus = []
    for n in read_annexb(data):
        if n.nal_type == NAL_SEI:
            if keep_hash and n.payload and n.payload[0] == 0:
                nalus.append(n)          # payload type 0 = picture hash
            continue
        nalus.append(n)
    return write_annexb(nalus)


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    keep = "--keep-hash" in args
    args = [a for a in args if not a.startswith("--")]
    if len(args) != 2:
        raise SystemExit("usage: sei_removal in.bin out.bin [--keep-hash]")
    with open(args[0], "rb") as f:
        data = f.read()
    out = remove_sei(data, keep)
    with open(args[1], "wb") as f:
        f.write(out)
    print(f"{args[0]} -> {args[1]}: {len(data)} -> {len(out)} bytes")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
