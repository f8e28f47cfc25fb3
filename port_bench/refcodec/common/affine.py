"""4-parameter affine motion: subblock MC + batched gradient search.

PyTorch counterpart of `vvc_mm_tpu/common/affine.py` (reference:
source/Lib/CommonLib/InterPrediction.cpp:1143 xPredAffineBlk — per-4x4
subblock MVs from control-point MVs; the encoder's affine ME seeded by
AffineGradientSearch.{cpp,h} — per-block least squares on spatial
gradients; affine is CLASSIC-only, disabled under MM models,
InterSearch.cpp:2783).

Parameterization (zoom+rotation, VVC 4-param equivalent):
  mv(x, y) = mv0 + ( d.x * x - d.y * y,  d.y * x + d.x * y ) / s
with block-local pixel coords (x, y), block size s, mv0 the top-left
control-point MV (1/16-pel) and d = mv_TR - mv_TL (1/16-pel across the
block width) — the two signalled quantities.

The affine field of every block becomes absolute per-4x4-subblock
positions (integer math, shared by encoder and decoder), predicted by the
position MC of the multi-model path: kernels K1 (luma) and K2 (chroma) on
the card, their plain versions on the CPU.  The encoder's parameter search
is one batched float32 4x4 normal-equation solve per block, in the JAX
package's operation order; its einsum sums and solve may round an ulp away
from XLA's, so a block's rounded parameters can differ from the JAX
encoder's (the tests count them).  The decoder reads integer parameters
only, so it is bit-exact everywhere.
"""
from __future__ import annotations

import torch

from .inter_frame import MC_MARGIN, _recon_planes, pad_ref
from .mm import mc as mm_mc


def _round_shift(v: torch.Tensor, sh: int) -> torch.Tensor:
    return (v + (1 << (sh - 1))) >> sh


def _up(f: torch.Tensor, rep: int) -> torch.Tensor:
    """Per-block grid -> per-subblock grid (each block rep x rep)."""
    return f.repeat_interleave(rep, 0).repeat_interleave(rep, 1)


def affine_positions(mv0: torch.Tensor, dmv: torch.Tensor, block_size: int,
                     width: int, height: int) -> torch.Tensor:
    """Per-4x4-subblock absolute 1/16-pel positions of the affine field.

    Args:
      mv0: (nby, nbx, 2) top-left CPMV, 1/16-pel.
      dmv: (nby, nbx, 2) mv_TR - mv_TL, 1/16-pel over the block width.
    Returns (H/4, W/4, 2) int32 subblock-origin positions (mm/mc.py form).
    """
    s = block_size
    log2s = s.bit_length() - 1
    nsy, nsx = height // 4, width // 4
    rep = s // 4
    dev = mv0.device
    mx, my = (_up(mv0[..., i].to(torch.int32), rep) for i in (0, 1))
    dx, dy = (_up(dmv[..., i].to(torch.int32), rep) for i in (0, 1))
    # subblock-centre offsets inside the block, in pixels
    cx = (torch.arange(nsx, dtype=torch.int32, device=dev) % rep) * 4 + 2
    cy = (torch.arange(nsy, dtype=torch.int32, device=dev) % rep) * 4 + 2
    cx = cx[None, :].expand(nsy, nsx)
    cy = cy[:, None].expand(nsy, nsx)
    sub_mvx = mx + _round_shift(dx * cx - dy * cy, log2s)
    sub_mvy = my + _round_shift(dy * cx + dx * cy, log2s)
    base_x = (torch.arange(nsx, dtype=torch.int32, device=dev) * 64)[None, :]
    base_y = (torch.arange(nsy, dtype=torch.int32, device=dev) * 64)[:, None]
    return torch.stack([base_x + sub_mvx, base_y + sub_mvy], -1)


def mixed_positions(mvs: torch.Tensor, mv0_aff: torch.Tensor,
                    dmv: torch.Tensor, aff_flag: torch.Tensor,
                    block_size: int, width: int, height: int
                    ) -> torch.Tensor:
    """Resolve a mixed translational/affine frame to one position grid:
    one position-MC pass serves both."""
    trans = mm_mc.classic_positions(width, height, mvs, block_size)
    aff = affine_positions(mv0_aff, dmv, block_size, width, height)
    f = _up(aff_flag, block_size // 4)
    return torch.where(f[..., None], aff, trans).to(torch.int32)


def mc_predict_positions(ref_y, ref_u, ref_v, positions, bit_depth: int,
                         wrap_around: bool):
    """Full-frame MC of all planes from a subblock position grid: K1 for
    luma, K2 for each chroma plane (each 4x4 luma subblock is one 2x2
    chroma subblock, the same positions read at 1/32 pel)."""
    py = mm_mc.mc_luma_positions(pad_ref(ref_y, MC_MARGIN, wrap_around),
                                 positions, MC_MARGIN, bit_depth)
    pu, pv = (mm_mc.mc_chroma_positions(
        pad_ref(r, MC_MARGIN // 2, wrap_around), positions, MC_MARGIN // 2,
        bit_depth) for r in (ref_u, ref_v))
    return py, pu, pv


def reconstruct_p_frame_affine(mv_grid, aff_flag, dmv, lev_y, lev_u, lev_v,
                               ref_y, ref_u, ref_v, qp: int,
                               block_size: int, bit_depth: int = 8,
                               wrap_around: bool = False):
    """Shared encoder/decoder P reconstruction with per-block affine flags:
    mv_grid holds the translational MV (flag off) or the affine TL CPMV
    (flag on); dmv is only read where the flag is set."""
    h, w = ref_y.shape
    pos = mixed_positions(mv_grid, mv_grid, dmv, aff_flag, block_size, w, h)
    pred = mc_predict_positions(ref_y, ref_u, ref_v, pos, bit_depth,
                                wrap_around)
    return _recon_planes(pred, (lev_y, lev_u, lev_v), block_size, qp,
                         bit_depth)


