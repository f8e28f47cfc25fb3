"""K1-K6's plain versions, under the names of the port's
`ops/mc_kernel.py`: position-based MC of 4x4 luma (2x2 chroma)
subblocks, each from its own absolute 1/16-pel position, and the
search's decision SADs.  The port's wrappers take these for CPU tensors
and launch its kernels for CUDA ones; the frozen reference runs on the
CPU and launches no kernel.  Ported from the JAX package's XLA mirror
(`common/mm/mc.py` _mc_luma_positions_xla / _mc_chroma_positions_xla,
sad_block_positions_xla, mc_block_positions_xla, the loop of
sad_positions_multi and sad_bilinear_positions_xla).
"""
from __future__ import annotations

import torch

from ..common import interp
from ..common.typedefs import NTAPS_CHROMA, NTAPS_LUMA


def _assemble(blocks: torch.Tensor, nsy: int, nsx: int, s: int
              ) -> torch.Tensor:
    return (blocks.reshape(nsy, nsx, s, s).permute(0, 2, 1, 3)
            .reshape(nsy * s, nsx * s))


# ---------------------------------------------------------------------------
# Plain versions (the arithmetic the kernels must reproduce bit for bit)
# ---------------------------------------------------------------------------
def mc_luma_positions_plain(ref_padded: torch.Tensor, positions: torch.Tensor,
                            margin: int, bit_depth: int = 8) -> torch.Tensor:
    """(H+2m, W+2m) int32 padded reference + (nsy, nsx, 2) int32 1/16-pel
    subblock positions -> (4*nsy, 4*nsx) int32 prediction."""
    nsy, nsx, _ = positions.shape
    pos = positions.reshape(-1, 2)
    xi = (pos[:, 0] >> 4) + margin - (NTAPS_LUMA // 2 - 1)
    yi = (pos[:, 1] >> 4) + margin - (NTAPS_LUMA // 2 - 1)
    xi = torch.clamp(xi, 0, ref_padded.shape[1] - (4 + NTAPS_LUMA - 1))
    yi = torch.clamp(yi, 0, ref_padded.shape[0] - (4 + NTAPS_LUMA - 1))
    patch = interp.gather_patches_t(ref_padded, yi, xi, 4 + NTAPS_LUMA - 1,
                                    4 + NTAPS_LUMA - 1)
    val = interp.interp_luma_t(patch, pos[:, 0] & 15, pos[:, 1] & 15, 4, 4,
                               bit_depth)
    pix = interp.finalize_uni(val, bit_depth)          # (4, 4, B)
    return _assemble(pix.permute(2, 0, 1), nsy, nsx, 4)


def mc_chroma_positions_plain(ref_padded: torch.Tensor,
                              positions: torch.Tensor, margin: int,
                              bit_depth: int = 8) -> torch.Tensor:
    """Chroma (4:2:0): the same positions at 1/32 pel over 2x2 subblocks
    -> (2*nsy, 2*nsx) int32."""
    nsy, nsx, _ = positions.shape
    pos = positions.reshape(-1, 2)
    xi = (pos[:, 0] >> 5) + margin - (NTAPS_CHROMA // 2 - 1)
    yi = (pos[:, 1] >> 5) + margin - (NTAPS_CHROMA // 2 - 1)
    xi = torch.clamp(xi, 0, ref_padded.shape[1] - (2 + NTAPS_CHROMA - 1))
    yi = torch.clamp(yi, 0, ref_padded.shape[0] - (2 + NTAPS_CHROMA - 1))
    patch = interp.gather_patches_t(ref_padded, yi, xi, 2 + NTAPS_CHROMA - 1,
                                    2 + NTAPS_CHROMA - 1)
    val = interp.interp_chroma_t(patch, pos[:, 0] & 31, pos[:, 1] & 31, 2, 2,
                                 bit_depth)
    pix = interp.finalize_uni(val, bit_depth)          # (2, 2, B)
    return _assemble(pix.permute(2, 0, 1), nsy, nsx, 2)


# ---------------------------------------------------------------------------
# K3 / K4 / K5: the search's decision SADs
# ---------------------------------------------------------------------------
def _band_pixels(ref_padded: torch.Tensor, positions: torch.Tensor,
                 margin: int, s: int, bit_depth: int) -> torch.Tensor:
    """(K, nby, nbx, 2) block positions -> (4, s, K*nby*nbx) predicted
    first-band samples of every (candidate, block)."""
    pos = positions.reshape(-1, 2)
    xi = (pos[:, 0] >> 4) + margin - (NTAPS_LUMA // 2 - 1)
    yi = (pos[:, 1] >> 4) + margin - (NTAPS_LUMA // 2 - 1)
    xi = torch.clamp(xi, 0, ref_padded.shape[1] - (s + NTAPS_LUMA - 1))
    yi = torch.clamp(yi, 0, ref_padded.shape[0] - (4 + NTAPS_LUMA - 1))
    patch = interp.gather_patches_t(ref_padded, yi, xi, 4 + NTAPS_LUMA - 1,
                                    s + NTAPS_LUMA - 1)   # (11, s+7, B)
    val = interp.interp_luma_t(patch, pos[:, 0] & 15, pos[:, 1] & 15, 4, s,
                               bit_depth)
    return interp.finalize_uni(val, bit_depth)            # (4, s, B)


def sad_block_positions_plain(ref_padded: torch.Tensor,
                              orig_bands: torch.Tensor,
                              positions: torch.Tensor, margin: int, s: int,
                              bit_depth: int = 8) -> torch.Tensor:
    """Per-BLOCK decision SADs of each block's first 4-pixel row band
    sampled at the block-translational position (exact 8-tap filter).
    positions (K, nby, nbx, 2); orig_bands (nby*4, nbx*s) ->
    (K, nby, nbx) int32."""
    k, nby, nbx, _ = positions.shape
    pix = _band_pixels(ref_padded, positions, margin, s, bit_depth)
    ob = orig_bands.reshape(nby, 4, nbx, s).permute(1, 3, 0, 2)
    ob = ob.reshape(4, s, nby * nbx).repeat(1, 1, k)
    return (pix - ob).abs().sum(dim=(0, 1)).reshape(k, nby, nbx) \
        .to(torch.int32)


def mc_block_positions_plain(ref_padded: torch.Tensor,
                             positions: torch.Tensor, margin: int, s: int,
                             bit_depth: int = 8) -> torch.Tensor:
    """Each block's predicted first 4-pixel row band at the
    block-translational position.  positions (K, nby, nbx, 2) ->
    (K, nby*4, nbx*s) int32."""
    k, nby, nbx, _ = positions.shape
    pix = _band_pixels(ref_padded, positions, margin, s, bit_depth)
    pix = pix.permute(2, 0, 1).reshape(k, nby, nbx, 4, s)
    return pix.permute(0, 1, 3, 2, 4).reshape(k, nby * 4, nbx * s)


def sad_luma_positions_plain(ref_padded: torch.Tensor, orig: torch.Tensor,
                             positions: torch.Tensor, margin: int,
                             bit_depth: int = 8) -> torch.Tensor:
    """Exact (8-tap) per-subblock SAD for K candidate fields: one K1-style
    prediction per field, reduced over 4x4 subblocks.  orig (4*nsy, 4*nsx),
    positions (K, nsy, nsx, 2) -> (K, nsy, nsx) int32."""
    outs = []
    for i in range(positions.shape[0]):
        pred = mc_luma_positions_plain(ref_padded, positions[i], margin,
                                       bit_depth)
        d = (orig - pred).abs()
        h, w = d.shape
        outs.append(d.reshape(h // 4, 4, w // 4, 4).sum(dim=(1, 3)))
    return torch.stack(outs).to(torch.int32)


def sad_bilinear_positions_plain(ref_padded: torch.Tensor,
                                 orig: torch.Tensor, positions: torch.Tensor,
                                 margin: int) -> torch.Tensor:
    """Per-4x4-subblock decision SADs with 2-tap bilinear interpolation for
    K candidate fields (ranks search candidates only): a 5x5 patch at the
    floor position, no clip to the bit depth.  orig (4*nsy, 4*nsx),
    positions (K, nsy, nsx, 2) -> (K, nsy, nsx) int32."""
    k, nsy, nsx, _ = positions.shape
    pos = positions.reshape(-1, 2)
    xi = torch.clamp((pos[:, 0] >> 4) + margin, 0, ref_padded.shape[1] - 5)
    yi = torch.clamp((pos[:, 1] >> 4) + margin, 0, ref_padded.shape[0] - 5)
    patch = interp.gather_patches_t(ref_padded, yi, xi, 5, 5)   # (5, 5, B)
    fx = (pos[:, 0] & 15)[None, None, :]
    fy = (pos[:, 1] & 15)[None, None, :]
    h = (patch[:, 0:4] * (16 - fx) + patch[:, 1:5] * fx + 8) >> 4
    pix = (h[0:4] * (16 - fy) + h[1:5] * fy + 8) >> 4           # (4, 4, B)
    ob = orig.reshape(nsy, 4, nsx, 4).permute(1, 3, 0, 2)
    ob = ob.reshape(4, 4, nsy * nsx).repeat(1, 1, k)
    return (pix - ob).abs().sum(dim=(0, 1)).reshape(k, nsy, nsx) \
        .to(torch.int32)


mc_luma_positions = mc_luma_positions_plain                  # K1
mc_chroma_positions = mc_chroma_positions_plain              # K2
sad_block_positions = sad_block_positions_plain              # K3
mc_block_positions = mc_block_positions_plain                # K4
sad_luma_positions = sad_luma_positions_plain                # K5
sad_bilinear_positions = sad_bilinear_positions_plain        # K6
