"""Wavefront-batched intra frame encoding and decoding.

PyTorch counterpart of `vvc_mm_tpu/common/wavefront.py` (reference:
EncSlice.cpp:1669 encodeCtus -> EncCu.cpp:499 xCompressCU; DecSlice.cpp:74
raster decode; the anti-diagonal wavefront d = 2*by + bx makes every block
of a diagonal independent).

The JAX package runs one `lax.scan` step per diagonal.  Here the scan is a
Python loop over diagonals, each diagonal's blocks batched: gather every
block's references from the state before the step, predict (the encoder:
all 67 modes, SATD + lambda * bits decision, transform and quantize),
reconstruct, then scatter.  Luma is scattered before chroma is gathered, as
in the scan step.  The scan's padded slots (invalid entries) only ever
write into the buffer's far margin, which no valid block reads: the decoder
skips them, the encoder keeps them so that its per-step outputs have the
scan's fixed shape.

Only the base toolset is carried: CCLM, MIP, LFNST, MRL, transform skip,
BDPCM, MTS, IBC, RDOQ, dependent quantization and lossless coding raise
NotImplementedError (ROADMAP queue 1 item 9).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import intra, quant, rom, transforms
from .inter_frame import first_argmin
from .rdcost import satd
from ..device import resolve_device

MARGIN = 64            # intra buffer margin (>= 2*S + slack)


@functools.lru_cache(maxsize=None)
def wavefront_coords(nby: int, nbx: int) -> tuple[np.ndarray, np.ndarray]:
    """Static wavefront schedule.

    Returns (coords, valid): coords (steps, bmax, 2) int32 block indices,
    valid (steps, bmax) bool.  Wavefront d = 2*by + bx."""
    dmax = 2 * (nby - 1) + (nbx - 1)
    rows = []
    for d in range(dmax + 1):
        blocks = [(by, d - 2 * by) for by in range(nby)
                  if 0 <= d - 2 * by < nbx]
        rows.append(blocks)
    bmax = max(len(r) for r in rows)
    coords = np.zeros((len(rows), bmax, 2), dtype=np.int32)
    valid = np.zeros((len(rows), bmax), dtype=bool)
    for i, r in enumerate(rows):
        for k, (by, bx) in enumerate(r):
            coords[i, k] = (by, bx)
            valid[i, k] = True
    return coords, valid


def grid_to_steps(grid: np.ndarray, coords: np.ndarray,
                  valid: np.ndarray) -> np.ndarray:
    """(nby, nbx, ...) grid -> (steps, bmax, ...) scan order (host)."""
    out = np.zeros(coords.shape[:2] + grid.shape[2:], grid.dtype)
    v = valid.reshape(-1)
    by = coords[..., 0].reshape(-1)[v]
    bx = coords[..., 1].reshape(-1)[v]
    flat = out.reshape((-1,) + grid.shape[2:])
    flat[v] = grid[by, bx]
    return flat.reshape(out.shape)


def steps_to_grid(outs_steps: np.ndarray, coords: np.ndarray,
                  valid: np.ndarray) -> np.ndarray:
    """Inverse of grid_to_steps: per-step outputs (steps, bmax, ...) ->
    (nby, nbx, ...) grid (host)."""
    nby = coords[..., 0].max() + 1
    nbx = coords[..., 1].max() + 1
    out = np.zeros((nby, nbx) + outs_steps.shape[2:], outs_steps.dtype)
    v = valid.reshape(-1)
    by = coords[..., 0].reshape(-1)[v]
    bx = coords[..., 1].reshape(-1)[v]
    out[by, bx] = outs_steps.reshape((-1,) + outs_steps.shape[2:])[v]
    return out


def _mpm3(left: torch.Tensor, above: torch.Tensor) -> torch.Tensor:
    """Vectorised 3-entry MPM list, (B,) x2 -> (B, 3): mpm3_host for a
    batch (simplified HEVC-style derivation; the encoder's decision and
    the entropy coder share it)."""
    l = torch.where(left < 0, 0, left)
    a = torch.where(above < 0, 0, above)
    eq = l == a
    ang = eq & (l >= 2)
    prev = 2 + ((l - 2 + 64) % 65)
    nxt = 2 + ((l - 2 + 1) % 65)
    third = torch.full_like(l, 2)        # first of these neither l nor a
    for c in (18, 50, 1, 0):
        third = torch.where((l != c) & (a != c), c, third)
    m0 = torch.where(ang, l, torch.where(eq, 0, l))
    m1 = torch.where(ang, prev, torch.where(eq, 1, a))
    m2 = torch.where(ang, nxt, torch.where(eq, 50, third))
    return torch.stack([m0, m1, m2], dim=1).to(torch.int32)


def mpm3_host(left: int, above: int) -> list[int]:
    """3-entry MPM list for the entropy coders (host mirror of _mpm3;
    simplified HEVC-style derivation)."""
    l = max(left, 0)
    a = max(above, 0)
    if l == a:
        if l < 2:
            return [0, 1, 50]
        return [l, 2 + ((l - 2 + 64) % 65), 2 + ((l - 2 + 1) % 65)]
    for c in (0, 1, 50, 18, 2):
        if c != l and c != a:
            return [l, a, c]
    raise AssertionError


def _gather_cref(buf: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                 s: int) -> torch.Tensor:
    """Combined intra reference vectors [left reversed, corner, top] for
    blocks at padded-buffer coords (y0, x0): (B, 4s+1)."""
    ln = 2 * s
    ar = torch.arange(ln, device=buf.device)
    left = buf[y0[:, None] + ar[None, :], (x0 - 1)[:, None]]     # (B, ln)
    ar1 = torch.arange(ln + 1, device=buf.device)
    top = buf[(y0 - 1)[:, None], x0[:, None] - 1 + ar1[None, :]]  # (B, ln+1)
    return torch.cat([torch.flip(left, [1]), top], 1)


def _cref_index(y0: np.ndarray, x0: np.ndarray, s: int, shape
                ) -> tuple[np.ndarray, np.ndarray]:
    """Row and column indices (..., 4s+1) of _gather_cref's vector for
    blocks at (y0, x0) of a buffer of `shape`, as one gather.  The start of
    each run is clamped so that the run stays inside the buffer, as a
    dynamic slice's is: that only ever moves the dead-zone reads of masked
    lanes."""
    ln = 2 * s
    ly = np.clip(y0, 0, shape[0] - ln)[..., None] + np.arange(ln)[::-1]
    lx = np.broadcast_to(np.clip(x0 - 1, 0, shape[1] - 1)[..., None],
                         ly.shape)
    tx = np.clip(x0 - 1, 0, shape[1] - (ln + 1))[..., None] \
        + np.arange(ln + 1)
    ty = np.broadcast_to(np.clip(y0 - 1, 0, shape[0] - 1)[..., None],
                         tx.shape)
    return np.concatenate([ly, ty], -1), np.concatenate([lx, tx], -1)


def _block_index(y0: torch.Tensor, x0: torch.Tensor, s: int):
    ar = torch.arange(s, device=y0.device)
    return (y0[:, None, None] + ar[None, :, None],
            x0[:, None, None] + ar[None, None, :])


def _gather_blocks(buf: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                   s: int) -> torch.Tensor:
    """The (s, s) blocks at padded-buffer coords (y0, x0), any leading
    shape: (..., s, s)."""
    ar = torch.arange(s, device=buf.device)
    return buf[y0[..., None, None] + ar[:, None],
               x0[..., None, None] + ar[None, :]]


def _pad_to_buffer(plane: torch.Tensor, fill: int) -> torch.Tensor:
    h, w = plane.shape
    buf = torch.full((h + 2 * MARGIN, w + 2 * MARGIN), fill,
                     dtype=torch.int32, device=plane.device)
    buf[MARGIN:MARGIN + h, MARGIN:MARGIN + w] = plane
    return buf


def _tq_reconstruct(pred: torch.Tensor, resid: torch.Tensor | None,
                    levels: torch.Tensor | None, qp: int, s: int,
                    bit_depth: int, intra_slice: bool, luma: bool = True
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared transform/quant/reconstruct: the encoder passes resid (the
    levels are computed), the decoder passes levels.  Returns
    (levels, recon_block).

    Implicit MTS: small luma intra blocks (4..16) use DST-7 in both
    directions (reference: TrQuant.cpp:619 getTrTypes)."""
    log2s = s.bit_length() - 1
    tr = (rom.DST7 if (intra_slice and luma and 4 <= s <= 16)
          else rom.DCT2)
    if levels is None:
        coeff = transforms.forward_transform(resid, tr, tr,
                                             bit_depth=bit_depth)
        levels = quant.quantize(coeff, qp, log2s, log2s, bit_depth,
                                intra=intra_slice)
    dq = quant.dequantize(levels, qp, log2s, log2s, bit_depth)
    r = transforms.inverse_transform(dq, tr, tr, bit_depth=bit_depth)
    return levels, torch.clamp(pred + r, 0, (1 << bit_depth) - 1)


_UNPORTED = ("dep_quant", "use_cclm", "use_mip", "use_lfnst", "use_mrl",
             "use_ts", "use_bdpcm", "lossless", "use_ibc", "use_mts",
             "use_rdoq")


def _refuse_tools(tools: dict) -> None:
    unknown = sorted(set(tools) - set(_UNPORTED))
    if unknown:
        raise TypeError(f"unknown intra options {unknown}")
    on = [k for k in _UNPORTED if tools.get(k)]
    if on:
        raise NotImplementedError(
            f"intra tools {on}: ROADMAP queue 1 item 9 (intra tools)")


def encode_intra_frame(orig_y: torch.Tensor, orig_u: torch.Tensor,
                       orig_v: torch.Tensor, qp: int, block_size: int = 8,
                       bit_depth: int = 8, **tools):
    """Closed-loop wavefront intra encode of one frame, on the device of
    the planes it is given.

    Returns (outs, recon): outs the nine per-step outputs of the JAX scan
    in its order (mode, lm_flag, lfnst_idx, mrl, tsm, mtsm of shape
    (steps, bmax); lev_y, lev_u, lev_v of shape (steps, bmax, s, s) and
    (steps, bmax, s/2, s/2)), the tool outputs zero; recon the dict(y, u,
    v) of reconstructed planes (exact decoder output)."""
    _refuse_tools(tools)
    dev = orig_y.device
    s = block_size
    sc = s // 2
    h, w = orig_y.shape
    nby, nbx = h // s, w // s
    mid = 1 << (bit_depth - 1)
    # sqrt(lambda) as a float32, times the three mode-bit counts: the JAX
    # step multiplies in float32 (a weak-typed Python float) and then adds
    lam_satd = np.float32(math.sqrt(quant.lambda_from_qp(qp, intra=True)))
    c2, c3, c7 = (float(lam_satd * np.float32(b)) for b in (2.0, 3.0, 7.0))

    coords, valid = wavefront_coords(nby, nbx)
    oy, ou, ov = (_pad_to_buffer(p, mid) for p in (orig_y, orig_u, orig_v))
    ry, ru, rv = (torch.full_like(p, mid) for p in (oy, ou, ov))
    mode_map = torch.full((nby + 1, nbx + 1), -1, dtype=torch.int32,
                          device=dev)
    modes_grid = torch.arange(67, dtype=torch.int32, device=dev)[None, :]

    # every step's coordinates at once; masked lanes go to the dead zone
    # in the far margin corner, and to pad cell (0, 0) of the mode map, so
    # that their duplicate writes are deterministic
    by_np, bx_np = coords[..., 0].astype(np.int64), \
        coords[..., 1].astype(np.int64)

    def t(a):
        return torch.as_tensor(a, device=dev)

    vld_all = t(valid)
    by_all, bx_all = t(by_np), t(bx_np)
    y0_np = np.where(valid, MARGIN + by_np * s, ry.shape[0] - s - 4)
    x0_np = np.where(valid, MARGIN + bx_np * s, ry.shape[1] - s - 4)
    y0c_np = np.where(valid, MARGIN + by_np * sc, ru.shape[0] - sc - 4)
    x0c_np = np.where(valid, MARGIN + bx_np * sc, ru.shape[1] - sc - 4)
    y0_all, x0_all, y0c_all, x0c_all = (
        t(a) for a in (y0_np, x0_np, y0c_np, x0c_np))
    cy_all, cx_all = (t(a) for a in _cref_index(y0_np, x0_np, s, ry.shape))
    ccy_all, ccx_all = (
        t(a) for a in _cref_index(y0c_np, x0c_np, sc, ru.shape))
    my_all = t(np.where(valid, 1 + by_np, 0))
    mx_all = t(np.where(valid, 1 + bx_np, 0))
    # the originals never change: one gather for all steps
    ob_all = _gather_blocks(oy, y0_all, x0_all, s)
    obu_all = _gather_blocks(ou, y0c_all, x0c_all, sc)
    obv_all = _gather_blocks(ov, y0c_all, x0c_all, sc)

    modes_out, levy_out, levu_out, levv_out = [], [], [], []
    for step in range(coords.shape[0]):
        vld = vld_all[step]
        by, bx = by_all[step], bx_all[step]
        y0, x0 = y0_all[step], x0_all[step]
        y0c, x0c = y0c_all[step], x0c_all[step]
        # ---- luma decision
        pall = intra.predict_all_modes(ry[cy_all[step], cx_all[step]], s, s)
        ob = ob_all[step]
        dist = satd(pall, ob[:, None]).to(torch.float32)     # (B, 67)
        lm = mode_map[1 + by, bx]       # left neighbour (by, bx-1)
        am = mode_map[by, 1 + bx]       # above neighbour
        mpm = _mpm3(lm, am)
        bits_cost = torch.where(
            modes_grid == mpm[:, 0:1], c2,
            torch.where((modes_grid == mpm[:, 1:2])
                        | (modes_grid == mpm[:, 2:3]), c3, c7))
        mode = first_argmin(dist + bits_cost, dim=1)
        pred = torch.gather(
            pall, 1, mode[:, None, None, None].expand(-1, 1, s, s))[:, 0]
        mode = mode.to(torch.int32)
        lev_y, rec = _tq_reconstruct(pred, ob - pred, None, qp, s,
                                     bit_depth, True)
        ry[_block_index(y0, x0, s)] = rec
        my, mx = my_all[step], mx_all[step]
        mode_map[my, mx] = torch.where(vld, mode, mode_map[my, mx])
        # ---- chroma: the derived luma mode
        lev_c = []
        for buf, obc in ((ru, obu_all[step]), (rv, obv_all[step])):
            predc = intra.predict_mode(buf[ccy_all[step], ccx_all[step]],
                                       mode, sc, sc)
            lc, recc = _tq_reconstruct(predc, obc - predc, None, qp, sc,
                                       bit_depth, True, luma=False)
            buf[_block_index(y0c, x0c, sc)] = recc
            lev_c.append(lc)
        modes_out.append(mode)
        levy_out.append(lev_y)
        levu_out.append(lev_c[0])
        levv_out.append(lev_c[1])
    modes_steps = torch.stack(modes_out)
    zero = torch.zeros_like(modes_steps)
    outs = (modes_steps, zero, zero, zero, zero, zero,
            torch.stack(levy_out), torch.stack(levu_out),
            torch.stack(levv_out))
    recon = dict(y=ry[MARGIN:MARGIN + h, MARGIN:MARGIN + w],
                 u=ru[MARGIN:MARGIN + h // 2, MARGIN:MARGIN + w // 2],
                 v=rv[MARGIN:MARGIN + h // 2, MARGIN:MARGIN + w // 2])
    return outs, recon


def decode_intra_frame(modes_steps, lev_y, lev_u, lev_v, qp: int,
                       height: int, width: int, block_size: int = 8,
                       bit_depth: int = 8, device=None, **tools):
    """Wavefront intra decode from parsed modes/levels in scan order
    ((steps, bmax) and (steps, bmax, s, s) arrays, see grid_to_steps).
    Returns dict(y, u, v) of int32 planes on `device` (CUDA unless
    another device is named)."""
    _refuse_tools(tools)
    dev = resolve_device(device)
    s = block_size
    sc = s // 2
    h, w = height, width
    nby, nbx = h // s, w // s
    mid = 1 << (bit_depth - 1)
    coords, valid = wavefront_coords(nby, nbx)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    modes_steps, lev_y, lev_u, lev_v = (t(a) for a in (modes_steps, lev_y,
                                                      lev_u, lev_v))
    ry = torch.full((h + 2 * MARGIN, w + 2 * MARGIN), mid, dtype=torch.int32,
                    device=dev)
    ru = torch.full((h // 2 + 2 * MARGIN, w // 2 + 2 * MARGIN), mid,
                    dtype=torch.int32, device=dev)
    rv = ru.clone()
    coords_t = t(coords).to(torch.int64)
    for step in range(coords.shape[0]):
        n = int(valid[step].sum())        # valid slots lead each step
        by, bx = coords_t[step, :n, 0], coords_t[step, :n, 1]
        mode = modes_steps[step, :n]
        y0, x0 = MARGIN + by * s, MARGIN + bx * s
        y0c, x0c = MARGIN + by * sc, MARGIN + bx * sc
        nb_mode = torch.where(mode >= 67, 0, mode)
        pred = intra.predict_mode(_gather_cref(ry, y0, x0, s), nb_mode, s, s)
        _, rec = _tq_reconstruct(pred, None, lev_y[step, :n], qp, s,
                                 bit_depth, True)
        ry[_block_index(y0, x0, s)] = rec.to(torch.int32)
        for lev, buf in ((lev_u, ru), (lev_v, rv)):
            predc = intra.predict_mode(_gather_cref(buf, y0c, x0c, sc),
                                       nb_mode, sc, sc)
            _, recc = _tq_reconstruct(predc, None, lev[step, :n], qp, sc,
                                      bit_depth, True, luma=False)
            buf[_block_index(y0c, x0c, sc)] = recc.to(torch.int32)
    return dict(y=ry[MARGIN:MARGIN + h, MARGIN:MARGIN + w],
                u=ru[MARGIN:MARGIN + h // 2, MARGIN:MARGIN + w // 2],
                v=rv[MARGIN:MARGIN + h // 2, MARGIN:MARGIN + w // 2])
