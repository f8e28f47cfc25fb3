"""SubpicMergeApp analog: merge independently coded streams as subpictures.

The PyTorch port's copy of the JAX package's apps/subpic_merge.py; the
decode runs the port's DecLib on the card unless --Device names another.

Reference: source/App/SubpicMergeApp (1,631 LoC) — combines bitstreams of
independently decodable rectangles into one stream whose decoded picture is
their composition (VVC subpictures are "treated as pictures", MV-clipped to
their own area — here each input IS its own encode, so independence holds
by construction; the MCTS analog).

Merged format: a subpicture-layout SEI (payload type 20: grid columns +
per-subpic width/height) followed by the inputs' NALs tagged with
nuh_layer_id = subpic index (the extractor app recovers any single subpic
losslessly).  `decode_merged` composites the decoded subpictures into full
frames.

Usage:
  python -m vvc_mm_tpu_torch.apps.subpic_merge out.bin in0.bin in1.bin \
      [--cols N]
  python -m vvc_mm_tpu_torch.apps.subpic_merge --decode merged.bin out.yuv \
      [--Device=cpu]
"""
from __future__ import annotations

import sys

import numpy as np

from ..common.bitstream import (BitReader, BitWriter, NAL_SEI, NalUnit,
                                read_annexb, write_annexb)

SEI_SUBPIC_LAYOUT = 20


def merge(streams: list[bytes], cols: int) -> bytes:
    """Tag each stream's NALs with its subpic index; prepend a layout SEI."""
    dims = []
    for data in streams:
        from ..decoder.declib import DecLib
        from ..common.slice_ps import SPS
        from ..common.bitstream import NAL_SPS
        w = h = 0
        for n in read_annexb(data):
            if n.nal_type == NAL_SPS:
                sps = SPS.read(BitReader(n.payload))
                w, h = sps.width, sps.height
                break
        if not w:
            raise SystemExit("input without SPS")
        dims.append((w, h))
    bw = BitWriter()
    bw.write(SEI_SUBPIC_LAYOUT, 8)
    bw.write(len(streams), 8)
    bw.write(cols, 8)
    for (w, h) in dims:
        bw.write_uvlc(w)
        bw.write_uvlc(h)
    bw.align()
    nalus = [NalUnit(NAL_SEI, 0, bw.get_bytes())]
    for idx, data in enumerate(streams):
        for n in read_annexb(data):
            nalus.append(NalUnit(n.nal_type, n.temporal_id, n.payload, idx))
    return write_annexb(nalus)


def parse_layout(data: bytes):
    """Returns (n, cols, dims) from the layout SEI, or None."""
    for n in read_annexb(data):
        if n.nal_type == NAL_SEI and n.payload \
                and n.payload[0] == SEI_SUBPIC_LAYOUT:
            br = BitReader(n.payload)
            br.read(8)
            k = br.read(8)
            cols = br.read(8)
            dims = [(br.read_uvlc(), br.read_uvlc()) for _ in range(k)]
            return k, cols, dims
    return None


def decode_merged(data: bytes, device=None):
    """Decode a merged stream and composite subpictures on the grid,
    each subpicture with the port's DecLib on `device` (CUDA unless
    another is named).  Returns (frames, (W, H)) with frames a list of
    3-plane host lists."""
    from ..decoder.declib import DecLib
    layout = parse_layout(data)
    if layout is None:
        raise SystemExit("not a subpic-merged stream (no layout SEI)")
    k, cols, dims = layout
    per = {i: [] for i in range(k)}
    for n in read_annexb(data):
        if n.nal_type == NAL_SEI and n.payload \
                and n.payload[0] == SEI_SUBPIC_LAYOUT:
            continue
        per[n.layer_id].append(n)
    decoded = []
    for i in range(k):
        dec = DecLib(device=device)
        decoded.append([fr.numpy() for fr in
                        dec.decode_bytes(write_annexb(per[i]))])
    rows = -(-k // cols)
    col_w = [max(dims[r * cols + c][0]
                 for r in range(rows) if r * cols + c < k)
             for c in range(cols)]
    row_h = [max(dims[r * cols + c][1]
                 for c in range(cols) if r * cols + c < k)
             for r in range(rows)]
    W, H = sum(col_w), sum(row_h)
    frames = []
    nf = min(len(d) for d in decoded)
    for t in range(nf):
        planes = [np.zeros((H, W), np.int32),
                  np.zeros((H // 2, W // 2), np.int32),
                  np.zeros((H // 2, W // 2), np.int32)]
        for i in range(k):
            r, c = divmod(i, cols)
            x0, y0 = sum(col_w[:c]), sum(row_h[:r])
            for p, plane in enumerate(decoded[i][t]):
                sc = 1 if p == 0 else 2
                planes[p][y0 // sc:y0 // sc + plane.shape[0],
                          x0 // sc:x0 // sc + plane.shape[1]] = plane
        frames.append(planes)
    return frames, (W, H)


def main(argv: list[str] | None = None) -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    device = None
    for a in list(args):
        if a.startswith("--Device="):
            device = a.split("=", 1)[1] or None
            args.remove(a)
    if args and args[0] == "--decode":
        data = open(args[1], "rb").read()
        frames, (W, H) = decode_merged(data, device)
        from ..utils.yuv_io import VideoFormat, YuvWriter
        from ..common.typedefs import ChromaFormat
        wr = YuvWriter(args[2], VideoFormat(W, H, 8, ChromaFormat.C420))
        for planes in frames:
            wr.write_frame(planes)
        wr.close()
        print(f"composited {len(frames)} frames at {W}x{H}")
        return 0
    cols = 2
    if "--cols" in args:
        i = args.index("--cols")
        cols = int(args[i + 1])
        del args[i:i + 2]
    if len(args) < 3:
        raise SystemExit(__doc__)
    out, ins = args[0], args[1:]
    merged = merge([open(f, "rb").read() for f in ins], cols)
    open(out, "wb").write(merged)
    print(f"merged {len(ins)} subpicture streams -> {out} "
          f"({len(merged)} bytes, {cols} columns)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
