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

from . import quant
from .inter_frame import (MC_MARGIN, _me, _lambda_bits_x16, _recon_planes,
                          _residual_planes, _to_blocks, pad_ref)
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


def affine_search(orig_y, ref_y, mv_trans, block_size: int,
                  bit_depth: int = 8, wrap_around: bool = False,
                  iters: int = 2):
    """Batched affine parameter search seeded from translational MVs.

    For every block at once: predict with the current affine field (K1),
    linearize the photometric error around it (optical-flow normal
    equations with an affine basis), solve the per-block 4x4 system, and
    round the refined parameters to the signalled integer form (reference:
    AffineGradientSearch.cpp — same math, one CU at a time).  K1 runs
    iters + 1 times.

    Returns (mv0 (nby,nbx,2), dmv (nby,nbx,2), sad (nby,nbx)) int32,
    1/16 pel."""
    s = block_size
    h, w = orig_y.shape
    nby, nbx = h // s, w // s
    dev = orig_y.device
    f32 = torch.float32
    ry = pad_ref(ref_y, MC_MARGIN, wrap_around)
    ob = _to_blocks(orig_y, s).to(f32)

    # float state: u, v (1/16-pel at block origin), d (1/16-pel over width)
    u = mv_trans[..., 0].to(f32)
    v = mv_trans[..., 1].to(f32)
    dx = torch.zeros((nby, nbx), dtype=f32, device=dev)
    dy = torch.zeros((nby, nbx), dtype=f32, device=dev)
    xs = torch.arange(s, dtype=f32, device=dev)
    px = xs[None, :].expand(s, s)
    py_ = xs[:, None].expand(s, s)
    xr = torch.clamp(torch.arange(1, w + 1, device=dev), max=w - 1)
    xl = torch.clamp(torch.arange(-1, w - 1, device=dev), min=0)
    yd = torch.clamp(torch.arange(1, h + 1, device=dev), max=h - 1)
    yu = torch.clamp(torch.arange(-1, h - 1, device=dev), min=0)
    eye = 0.1 * torch.eye(4, dtype=f32, device=dev)[None]

    def quantized(u, v, dx, dy):
        mv0 = torch.stack([torch.round(u), torch.round(v)], -1).to(
            torch.int32)
        d = torch.stack([torch.round(dx), torch.round(dy)], -1).to(
            torch.int32)
        return mv0, d

    def predict(u, v, dx, dy):
        pos = affine_positions(*quantized(u, v, dx, dy), s, w, h)
        return mm_mc.mc_luma_positions(ry, pos, MC_MARGIN, bit_depth)

    for _ in range(iters):
        pred = predict(u, v, dx, dy)
        # central differences with edge replication, halved
        gx_p = (pred[:, xr] - pred[:, xl]).to(f32) / 2.0
        gy_p = (pred[yd] - pred[yu]).to(f32) / 2.0
        r = ob - _to_blocks(pred, s).to(f32)
        gx = _to_blocks(gx_p, s)
        gy = _to_blocks(gy_p, s)
        # basis: dmv_pix(x,y) = (du + (ddx*x - ddy*y)/s,
        #                        dv + (ddy*x + ddx*y)/s), in pixels/16
        f1 = gx / 16.0
        f2 = gy / 16.0
        f3 = (gx * px + gy * py_) / (16.0 * s)
        f4 = (-gx * py_ + gy * px) / (16.0 * s)
        F = torch.stack([f1, f2, f3, f4], dim=1)        # (B, 4, s, s)
        A = torch.einsum("bihw,bjhw->bij", F, F) + eye
        b = torch.einsum("bihw,bhw->bi", F, r)
        p = torch.linalg.solve(A, b[..., None])[..., 0]  # (B, 4)
        p = torch.clamp(p, -64.0, 64.0)
        u = u + p[:, 0].reshape(nby, nbx)
        v = v + p[:, 1].reshape(nby, nbx)
        dx = torch.clamp(dx + p[:, 2].reshape(nby, nbx), -128, 128)
        dy = torch.clamp(dy + p[:, 3].reshape(nby, nbx), -128, 128)

    mv0, d = quantized(u, v, dx, dy)
    pred = predict(u, v, dx, dy)
    sad = (_to_blocks(pred, s).to(f32) - ob).abs().sum(dim=(1, 2)).reshape(
        nby, nbx).to(torch.int32)
    return mv0, d, sad


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


def encode_p_frame_affine(orig_y, orig_u, orig_v, ref_y, ref_u, ref_v,
                          qp: int, block_size: int = 16, bit_depth: int = 8,
                          search_range: int = 24,
                          wrap_around: bool = False):
    """P encode with a per-block translational/affine decision (reference:
    EncCu affine vs normal inter RD checks, EncCu.cpp:4147/3328).  The
    reconstruction is the residual pass's own (the decoder's
    reconstruct_p_frame_affine gives the same samples from the same
    prediction), so the final prediction runs K1 once and K2 twice.

    Returns (mv_grid, aff_flag, dmv, lev_y, lev_u, lev_v, recon)."""
    s = block_size
    h, w = orig_y.shape
    lam = quant.lambda_from_qp(qp, intra=False)
    ry_pad = pad_ref(ref_y, MC_MARGIN, wrap_around)
    mv_t, sad_t = _me(orig_y, ry_pad, s, search_range, _lambda_bits_x16(qp),
                      bit_depth)
    mv0_a, dmv, sad_a = affine_search(orig_y, ref_y, mv_t, s, bit_depth,
                                      wrap_around)
    # rate penalty: the extra dmv components + the flag bit
    f32 = torch.float32
    extra = (2.0 * torch.log2(dmv[..., 0].abs().to(f32) + 1)
             + 2.0 * torch.log2(dmv[..., 1].abs().to(f32) + 1) + 6.0)
    lam_sqrt = torch.tensor(lam, dtype=f32) ** 0.5
    aff = sad_a.to(f32) + lam_sqrt.to(orig_y.device) * extra < sad_t.to(f32)
    # degenerate affine (dmv == 0) is just translation — keep the flag off
    aff = aff & (dmv != 0).any(-1)
    mv_grid = torch.where(aff[..., None], mv0_a, mv_t.to(torch.int32))
    dmv = torch.where(aff[..., None], dmv, 0)
    pos = mixed_positions(mv_grid, mv_grid, dmv, aff, s, w, h)
    pred = mc_predict_positions(ref_y, ref_u, ref_v, pos, bit_depth,
                                wrap_around)
    out = _residual_planes((orig_y, orig_u, orig_v), pred, s, qp, bit_depth)
    return (mv_grid, aff, dmv) + out
