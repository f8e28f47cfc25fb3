"""Inter-prediction helpers shared by the multi-model reconstruction.

PyTorch counterpart of the helpers in `vvc_mm_tpu/common/inter_frame.py`
that the MM paths use: the MC margin, reference padding with ERP
wrap-around, the plane <-> block-batch reshapes and the encoder's residual
pass.  The classic (per-block MV) inter path is ROADMAP queue 1 item 8.
"""
from __future__ import annotations

import torch

from . import quant, transforms

MC_MARGIN = 80     # ref padding: search range + filter taps + slack


def _edge_pad_rows(p: torch.Tensor, margin: int) -> torch.Tensor:
    top = p[:1].expand(margin, -1)
    bot = p[-1:].expand(margin, -1)
    return torch.cat([top, p, bot], 0)


def pad_ref(plane: torch.Tensor, margin: int = MC_MARGIN,
            wrap_around: bool = False) -> torch.Tensor:
    """Edge-extend a reconstructed plane for MC.  With `wrap_around`, the
    horizontal padding wraps (ERP 360 content; reference: Picture.cpp:94
    PIC_RECON_WRAP + Mv.cpp:113 wrapClipMv)."""
    w = plane.shape[1]
    if wrap_around:
        xs = torch.remainder(torch.arange(-margin, w + margin,
                                          device=plane.device), w)
        p = plane[:, xs]      # modular gather: correct even for margin > W
    else:
        p = torch.cat([plane[:, :1].expand(-1, margin), plane,
                       plane[:, -1:].expand(-1, margin)], 1)
    return _edge_pad_rows(p, margin).contiguous()


def _to_blocks(plane: torch.Tensor, s: int) -> torch.Tensor:
    h, w = plane.shape
    return (plane.reshape(h // s, s, w // s, s).permute(0, 2, 1, 3)
            .reshape(-1, s, s))


def _from_blocks(blocks: torch.Tensor, nby: int, nbx: int) -> torch.Tensor:
    s = blocks.shape[-1]
    return (blocks.reshape(nby, nbx, s, s).permute(0, 2, 1, 3)
            .reshape(nby * s, nbx * s))


def _block_coords(nby: int, nbx: int, s: int, device=None):
    idx = torch.arange(nby * nbx, dtype=torch.int32, device=device)
    return (idx // nbx) * s, (idx % nbx) * s


def _residual_pass(orig: torch.Tensor, pred: torch.Tensor, s: int, qp: int,
                   bit_depth: int):
    """Transform/quant the residual and reconstruct — returns (levels
    (nby, nbx, s, s), recon_plane)."""
    h, w = orig.shape
    nby, nbx = h // s, w // s
    log2s = s.bit_length() - 1
    ob = _to_blocks(orig, s)
    pb = _to_blocks(pred, s)
    coeff = transforms.forward_transform(ob - pb, bit_depth=bit_depth)
    levels = quant.quantize(coeff, qp, log2s, log2s, bit_depth, intra=False)
    dq = quant.dequantize(levels, qp, log2s, log2s, bit_depth)
    r = transforms.inverse_transform(dq, bit_depth=bit_depth)
    rec = torch.clamp(pb + r, 0, (1 << bit_depth) - 1)
    return levels.reshape(nby, nbx, s, s), _from_blocks(rec, nby, nbx)


def first_argmin(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Index of the FIRST minimum along `dim` (int64), as jnp.argmin gives
    it.  The search relies on this tie rule (a tie keeps the centre, the
    earlier model, the earlier candidate), so it is taken explicitly
    rather than left to a device's reduction order."""
    n = t.shape[dim]
    shape = [1] * t.dim()
    shape[dim] = n
    idx = torch.arange(n, device=t.device).reshape(shape)
    mn = t.min(dim=dim, keepdim=True).values
    return torch.where(t == mn, idx, n).min(dim=dim).values
