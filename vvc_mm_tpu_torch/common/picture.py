"""Picture & DPB data model.

The analog of the reference Picture/PelStorage/PicList (reference:
source/Lib/CommonLib/Picture.cpp — per-picture plane storage incl. the
wrap-around reconstruction copy for ERP, PIC_RECON_WRAP created at
Picture.cpp:94, fetched via getRecoBuf(compID, wrap) at :228-235; DPB shared
per layer via EncLibCommon.h:52-54).

Planes are int32 tensors on the device the caller placed them on, padded
with a fixed margin (border extension) so that motion compensation can
gather out-of-frame positions without per-access clamping; ERP horizontal
wrap-around copies the opposite columns into the margin instead of keeping
a second full copy (the wrap buffer of the reference).  psnr is host code
on numpy arrays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .typedefs import ChromaFormat, SliceType

# margin large enough for 8-tap MC at max MV + MM reprojection overshoot
PIC_MARGIN = 80


def pad_plane(plane: torch.Tensor, margin: int = PIC_MARGIN,
              wrap: bool = False) -> torch.Tensor:
    """Border-extend a (H, W) plane by `margin` on all sides, on the
    plane's device.

    wrap=True pads left/right by horizontal wrap-around (ERP 360 content,
    reference: Picture.cpp PIC_RECON_WRAP + Mv.cpp:113-163 wrapClipMv);
    vertical is always edge-replicated."""
    h, w = plane.shape
    if wrap:
        p = torch.cat([plane[:, -margin:], plane, plane[:, :margin]], dim=1)
    else:
        cols = torch.arange(-margin, w + margin, device=plane.device)
        p = plane[:, cols.clamp(0, w - 1)]
    rows = torch.arange(-margin, h + margin, device=plane.device)
    return p[rows.clamp(0, h - 1)]


@dataclass
class Picture:
    """One picture: original and/or reconstructed planes + coding state.

    reference: Picture.{cpp,h} (1,946 LoC).  Motion/model buffers are dense
    tensors at 4x4 granularity (reference: CodingStructure.h:273-289)."""
    poc: int
    width: int
    height: int
    bit_depth: int = 8
    chroma_format: ChromaFormat = ChromaFormat.C420
    temporal_id: int = 0
    slice_type: SliceType = SliceType.I
    wrap_around: bool = False

    orig: Optional[list[torch.Tensor]] = None     # [Y, Cb, Cr] (H, W) int32
    recon: Optional[list[torch.Tensor]] = None    # reconstructed planes
    recon_padded: Optional[list[torch.Tensor]] = None  # margin-extended recon

    # dense per-4x4 motion state (filled by encoder/decoder):
    #   mv:     (H/4, W/4, 2 lists, 2) int32 1/16-pel
    #   refidx: (H/4, W/4, 2) int32, -1 = unused list
    #   model:  (H/4, W/4, 2) int32 MotionModelID
    mv: Optional[torch.Tensor] = None
    refidx: Optional[torch.Tensor] = None
    model: Optional[torch.Tensor] = None

    is_reference: bool = True
    is_output: bool = False

    def finalize_recon(self) -> None:
        """Create the margin-extended reconstruction used as an MC reference
        (the analog of extendPicBorder + wrap copy, Picture.cpp:775-956)."""
        assert self.recon is not None
        self.recon_padded = [pad_plane(p, PIC_MARGIN, wrap=self.wrap_around)
                             for p in self.recon]

    def md5(self) -> str:
        """Decoded-picture hash (reference: PicYuvMD5.cpp / libmd5; the
        bit-exactness oracle of SURVEY.md §4.1)."""
        import hashlib
        m = hashlib.md5()
        nbytes = 2 if self.bit_depth > 8 else 1
        for p in self.recon:
            arr = p.cpu().numpy() if torch.is_tensor(p) else np.asarray(p)
            if nbytes == 1:
                m.update(arr.astype(np.uint8).tobytes())
            else:
                m.update(arr.astype("<u2").tobytes())
        return m.hexdigest()


class DecodedPictureBuffer:
    """DPB: reference-picture list management (reference: EncLib.cpp:2213
    selectReferencePictureList; DecLib.cpp:785 finishPicture output logic).

    Round-1 RPL model: low-delay P/B uses the nearest `num_refs` pictures in
    decode order; random-access hierarchies pass explicit ref POC lists."""

    def __init__(self, max_size: int = 16) -> None:
        self.pics: list[Picture] = []
        self.max_size = max_size

    def add(self, pic: Picture) -> None:
        self.pics.append(pic)
        self.pics.sort(key=lambda p: p.poc)
        refs = [p for p in self.pics if p.is_reference]
        while len(refs) > self.max_size:
            refs[0].is_reference = False
            refs = refs[1:]
        self.pics = [p for p in self.pics
                     if p.is_reference or not p.is_output]

    def get(self, poc: int) -> Picture:
        for p in self.pics:
            if p.poc == poc:
                return p
        raise KeyError(f"POC {poc} not in DPB")

    def ref_list(self, cur_poc: int, ref_pocs: list[int]) -> list[Picture]:
        return [self.get(p) for p in ref_pocs if p != cur_poc]

    def clear(self) -> None:
        self.pics.clear()


def psnr(orig: np.ndarray, recon: np.ndarray, bit_depth: int = 8) -> float:
    maxv = (1 << bit_depth) - 1
    # int32 diff/square (|diff| <= 2^16 so d*d fits), one float64 reduce —
    # ~5x cheaper than the float64-plane formulation on the host
    d = np.asarray(orig, np.int32) - np.asarray(recon, np.int32)
    mse = float(np.mean(d * d, dtype=np.float64))
    if mse == 0:
        return 999.99
    return 10.0 * np.log10(maxv * maxv / mse)
