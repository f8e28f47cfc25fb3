"""Frame and row sharding of the encoder over torch.distributed.

The PyTorch port of the JAX package's parallel/sharding.py.  The reference
is single-threaded; its parallelism is bitstream-structural (tiles / WPP /
chunked encode + Parcat, reference: EncSlice.cpp:2024-2113,
App/Parcat/parcat.cpp:393-427).  Here every rank of a process group is one
device of a ("gop", "tile") mesh:

  * frame parallelism (`encode_frames_sharded`): independent intra
    pictures, a contiguous share of them a rank;
  * row parallelism (`encode_p_frame_sharded`, `encode_b_frame_sharded`,
    `encode_p_frame_mm_sharded`): each rank codes one row slab of the
    current picture against the replicated reference(s);
    `encode_p_frame_sharded_ref` holds only the slab of the reference too
    and exchanges halo rows with its neighbours.

A rank codes its slab extended by `halo` rows of context on each inner
side (edge-replicated at the frame's own edges, as the unsharded padding
is) and keeps its own rows: every decision of the kept blocks, and of the
one block row beyond them that their merge candidates and deblocking
read, sees the same samples as in the unsharded encode, so the result is
bit-exact with it.  The multi-model slab carries its row origin into
MVReprojection (`rows=`): the models run at absolute rows, the search arm
follows the whole frame's height, and ERP wrap-around stays x-local.

Slabs and results travel as host arrays through the group's object
collectives (`all_gather_object`) and, for the halos, its point-to-point
calls (`send_object_list` / `recv_object_list`), so the same code runs on
gloo (CPU, or several ranks on one card) and on NCCL (a card a rank).
Every function is called by every rank of the group with the same
arguments and returns the whole result on every rank.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..common import inter_frame, wavefront
from ..device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """A ("gop", "tile") factoring of a process group's ranks."""
    gop: int
    tile: int
    group: object = None        # the process group (None: the default one)

    @property
    def size(self) -> int:
        return self.gop * self.tile

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group)


def make_mesh(n_devices: int | None = None, group=None) -> Mesh:
    """Factor the group's ranks into a ("gop", "tile") mesh.

    The gop axis gets the larger factor (frame parallelism scales
    near-linearly; tile parallelism is bounded by wavefront width)."""
    n = dist.get_world_size(group)
    if n_devices is not None and n_devices != n:
        raise ValueError(f"a mesh of {n_devices} devices over a group of "
                         f"{n} ranks")
    tile = 1
    for t in (2,):
        if n % t == 0 and n // t >= 2:
            tile = t
    return Mesh(n // tile, tile, group)


def _gather(mesh: Mesh, obj) -> list:
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def _host(t) -> np.ndarray:
    return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _tensors(arrays, device) -> list[torch.Tensor]:
    return [torch.as_tensor(np.ascontiguousarray(a, dtype=np.int32),
                            device=device) for a in arrays]


def _slab(h: int, n: int, r: int, unit: int) -> tuple[int, int]:
    if h % n or (h // n) % unit:
        raise ValueError(f"{h} rows do not split into {n} slabs of whole "
                         f"{unit}-row blocks")
    hs = h // n
    return r * hs, (r + 1) * hs


def _context(plane: np.ndarray, y0: int, y1: int, top: int,
             bot: int) -> np.ndarray:
    """plane rows [y0 - top, y1 + bot), all inside the frame."""
    return np.asarray(plane)[y0 - top:y1 + bot]


def _halos(mesh: Mesh, halo: int) -> tuple[int, int]:
    """The context rows above and below this rank's slab (none at the
    frame's edges, where the unsharded padding takes over)."""
    r, n = mesh.rank, mesh.size
    return (halo if r > 0 else 0), (halo if r < n - 1 else 0)


def default_halo(block_size: int, search_range: int,
                 neighbours: bool = False) -> int:
    """Context rows that cover the motion search's reads (search range +
    fractional refine + filter taps, whole blocks), plus one block row
    for merge candidates and deblocking when `neighbours`."""
    s = block_size
    return s * math.ceil((search_range + 8) / s) + (s if neighbours else 0)


def _crop_rows(t: torch.Tensor, top: int, bot: int) -> torch.Tensor:
    return t[top:t.shape[0] - bot]


def _slab_inputs(mesh: Mesh, planes, halo: int, unit: int):
    """This rank's slab (+ context) of full (Y, U, V) planes and its
    (y0, y1, top, bot) in luma rows."""
    h = np.asarray(planes[0]).shape[0]
    y0, y1 = _slab(h, mesh.size, mesh.rank, unit)
    top, bot = _halos(mesh, halo)
    top, bot = min(top, y0), min(bot, h - y1)
    luma = _context(planes[0], y0, y1, top, bot)
    chroma = [_context(p, y0 // 2, y1 // 2, top // 2, bot // 2)
              for p in planes[1:]]
    return [luma] + chroma, (y0, y1, top, bot)


# ---------------------------------------------------------------- frames
def encode_frames_sharded(frames: list[list[np.ndarray]], qp: int,
                          mesh: Mesh, block_size: int = 8,
                          bit_depth: int = 8, device=None):
    """Encode a batch of intra frames, a contiguous share of them a rank,
    with wavefront.encode_intra_frame on `device` (CUDA unless another is
    named).  Returns (outs, recon) on every rank: outs the nine per-step
    outputs, recon dict(y, u, v), each with a leading frame axis (host
    arrays).

    The frame count must be a multiple of the mesh size (pad at call site
    with repeated frames if needed)."""
    n = mesh.size
    if len(frames) % n:
        raise ValueError(f"{len(frames)} frames over {n} ranks")
    dev = resolve_device(device)
    k = len(frames) // n
    mine = frames[mesh.rank * k:(mesh.rank + 1) * k]
    outs, recons = [], []
    for f in mine:
        o, rec = wavefront.encode_intra_frame(*_tensors(f, dev), qp,
                                              block_size, bit_depth)
        outs.append([_host(t) for t in o])
        recons.append({c: _host(v) for c, v in rec.items()})
    parts = _gather(mesh, (outs, recons))
    outs = [o for p in parts for o in p[0]]
    recons = [r for p in parts for r in p[1]]
    return (tuple(np.stack([o[i] for o in outs]) for i in range(len(outs[0]))),
            {c: np.stack([r[c] for r in recons]) for c in recons[0]})


# ------------------------------------------------ rows, replicated refs
def encode_p_frame_sharded(orig: list[np.ndarray], ref: list[np.ndarray],
                           qp: int, mesh: Mesh, block_size: int = 16,
                           bit_depth: int = 8, search_range: int = 24,
                           wrap_around: bool = False, halo: int | None = None,
                           device=None):
    """Row-sharded classic P encode against the replicated reference: each
    rank runs inter_frame.encode_p_frame on its slab (+ `halo` context
    rows) and keeps its rows.  Returns (mvs, lev_y, lev_u, lev_v, recon
    dict) of the whole frame on every rank (host arrays)."""
    dev = resolve_device(device)
    s = block_size
    halo = default_halo(s, search_range) if halo is None else halo
    o, (_, _, top, bot) = _slab_inputs(mesh, orig, halo, s)
    r, _ = _slab_inputs(mesh, ref, halo, s)
    mvs, ly, lu, lv, rec = inter_frame.encode_p_frame(
        *_tensors(o, dev), *_tensors(r, dev), qp, s, bit_depth,
        search_range, wrap_around)
    tb, bb = top // s, bot // s
    part = ([_host(_crop_rows(t, tb, bb)) for t in (mvs, ly, lu, lv)],
            _crop_recon(rec, top, bot))
    return _finish(mesh, part)


def _crop_recon(rec: dict, top: int, bot: int) -> dict:
    return {c: _host(_crop_rows(v, top if c == "y" else top // 2,
                                bot if c == "y" else bot // 2))
            for c, v in rec.items()}


def _finish(mesh: Mesh, part):
    parts = _gather(mesh, part)
    grids = [np.concatenate([p[0][i] for p in parts])
             for i in range(len(parts[0][0]))]
    rec = {c: np.concatenate([p[1][c] for p in parts]) for c in parts[0][1]}
    return (*grids, rec)


def encode_b_frame_sharded(orig: list[np.ndarray], ref0: list[np.ndarray],
                           ref1: list[np.ndarray], qp: int, mesh: Mesh,
                           block_size: int = 16, bit_depth: int = 8,
                           search_range: int = 24,
                           wrap_around: bool = False,
                           halo: int | None = None, device=None):
    """Row-sharded B encode, both references replicated: each rank runs
    search_b_frame and bpred_and_residual on its slab (+ context).
    Returns (mv0, mv1, dirs, (lev_y, lev_u, lev_v), recon) on every
    rank."""
    dev = resolve_device(device)
    s = block_size
    halo = default_halo(s, search_range) if halo is None else halo
    o, (_, _, top, bot) = _slab_inputs(mesh, orig, halo, s)
    r0 = _tensors(_slab_inputs(mesh, ref0, halo, s)[0], dev)
    r1 = _tensors(_slab_inputs(mesh, ref1, halo, s)[0], dev)
    oy, ou, ov = _tensors(o, dev)
    mv0, mv1, dirs, _ = inter_frame.search_b_frame(
        oy, r0[0], r1[0], qp, s, bit_depth, search_range, wrap_around)
    ly, lu, lv, rec = inter_frame.bpred_and_residual(
        oy, ou, ov, tuple(r0), tuple(r1), mv0, mv1, dirs, qp, s, bit_depth,
        wrap_around)
    tb, bb = top // s, bot // s
    part = ([_host(_crop_rows(t, tb, bb)) for t in (mv0, mv1, dirs, ly, lu,
                                                    lv)],
            _crop_recon(rec, top, bot))
    mv0, mv1, dirs, ly, lu, lv, rec = _finish(mesh, part)
    return mv0, mv1, dirs, (ly, lu, lv), rec


def encode_p_frame_mm_sharded(reproj, active_models: list[int],
                              orig: list[np.ndarray],
                              ref: list[np.ndarray], qp: int, mesh: Mesh,
                              block_size: int = 16, bit_depth: int = 8,
                              search_range: int = 24,
                              wrap_around: bool = False,
                              halo: int | None = None):
    """Row-sharded multi-model P encode, reference replicated: each rank
    runs frame_codec.search_p_mm, merged_positions and enc_finish_p_mm
    (deblocked) on its slab (+ context, one block row more for the merge
    candidates and deblocking) through a slab of `reproj`
    (MVReprojection(..., rows=) on reproj's device), and keeps its rows.
    Returns (model_idx, mvs_stack, (lev_y, lev_u, lev_v), recon) on every
    rank (host arrays)."""
    from ..common.mm import frame_codec as mm_codec

    dev = reproj.device
    s = block_size
    halo = (default_halo(s, search_range, neighbours=True) if halo is None
            else halo)
    o, (y0, y1, top, bot) = _slab_inputs(mesh, orig, halo, s)
    r, _ = _slab_inputs(mesh, ref, halo, s)
    slab = reproj.slab(y0 - top, y1 + bot)
    oy, ou, ov = _tensors(o, dev)
    ry, ru, rv = _tensors(r, dev)
    midx, stack = mm_codec.search_p_mm(slab, active_models, oy, ry, qp, s,
                                       bit_depth, search_range, None,
                                       wrap_around)
    pos = mm_codec.merged_positions(slab, active_models, midx, stack, s,
                                    None)
    ly, lu, lv, rec = mm_codec.enc_finish_p_mm(
        midx, stack, pos, oy, ou, ov, ry, ru, rv, qp, s, bit_depth,
        wrap_around, True)
    tb, bb = top // s, bot // s
    part = ([_host(_crop_rows(midx, tb, bb)),
             _host(stack[:, tb:stack.shape[1] - bb])]
            + [_host(_crop_rows(t, tb, bb)) for t in (ly, lu, lv)],
            _crop_recon(rec, top, bot))
    parts = _gather(mesh, part)
    midx = np.concatenate([p[0][0] for p in parts])
    stack = np.concatenate([p[0][1] for p in parts], axis=1)
    levs = tuple(np.concatenate([p[0][i] for p in parts]) for i in (2, 3, 4))
    rec = {c: np.concatenate([p[1][c] for p in parts]) for c in parts[0][1]}
    return midx, stack, levs, rec


# ------------------------------------------- rows, a row-sharded reference
def _exchange(mesh: Mesh, rows: np.ndarray, hl: int):
    """The halo rows of a row-sharded plane from the neighbouring ranks,
    by the group's point-to-point calls: (rows above, rows below), each
    None at the frame's edges (even ranks send first, odd ranks receive
    first)."""
    r, n = mesh.rank, mesh.size
    g = mesh.group
    above = below = None

    def to(peer, obj):
        dist.send_object_list([obj], dst=_global(mesh, peer), group=g)

    def frm(peer):
        box = [None]
        dist.recv_object_list(box, src=_global(mesh, peer), group=g)
        return box[0]

    for phase in (0, 1):
        if (r + phase) % 2 == 0:
            if r > 0:
                to(r - 1, np.ascontiguousarray(rows[:hl]))
            if r < n - 1:
                to(r + 1, np.ascontiguousarray(rows[-hl:]))
        else:
            if r < n - 1:
                below = frm(r + 1)
            if r > 0:
                above = frm(r - 1)
    return above, below


def _global(mesh: Mesh, rank: int) -> int:
    return rank if mesh.group is None else dist.get_global_rank(mesh.group,
                                                                rank)


def encode_p_frame_sharded_ref(orig: list[np.ndarray],
                               ref: list[np.ndarray], qp: int, mesh: Mesh,
                               block_size: int = 16, bit_depth: int = 8,
                               search_range: int = 8,
                               wrap_around: bool = False,
                               halo: int | None = None, device=None):
    """Row-sharded P encode with a ROW-SHARDED reference plane and a halo
    exchange (the 6K / multi-host memory-scaling pattern): each rank keeps
    only its slab of the reference and receives `halo` reference rows
    from each neighbour over point-to-point calls, sized to cover the
    motion search (search_range + fractional + filter taps).  Frame-edge
    slabs edge-replicate, as pad_ref does, and ERP wrap-around stays a
    local x-axis operation, so the kept rows are bit-exact with the
    unsharded encode.  The current picture's halo rows are never kept:
    they are its slab's edge rows repeated.

    Returns (mvs, lev_y, lev_u, lev_v, recon dict) with global shapes on
    every rank."""
    dev = resolve_device(device)
    n = mesh.size
    s = block_size
    h = np.asarray(orig[0]).shape[0]
    hs = h // n
    halo = default_halo(s, search_range) if halo is None else halo
    if halo % s or halo > hs or hs % s or h % n:
        raise ValueError(f"halo {halo} over slabs of {hs} rows and "
                         f"{s}-blocks")
    hc = halo // 2
    y0, y1 = _slab(h, n, mesh.rank, s)

    def haloed(plane, lo, hi, hl):
        mine = np.asarray(plane)[lo:hi]          # this rank's slab only
        above, below = _exchange(mesh, mine, hl)
        top = (np.repeat(mine[:1], hl, 0) if above is None else above)
        bot = (np.repeat(mine[-1:], hl, 0) if below is None else below)
        return np.concatenate([top, mine, bot])

    def ext(plane, lo, hi, hl):
        mine = np.asarray(plane)[lo:hi]
        return np.concatenate([np.repeat(mine[:1], hl, 0), mine,
                               np.repeat(mine[-1:], hl, 0)])

    o = [ext(orig[0], y0, y1, halo)] + [ext(p, y0 // 2, y1 // 2, hc)
                                        for p in orig[1:]]
    r = [haloed(ref[0], y0, y1, halo)] + [haloed(p, y0 // 2, y1 // 2, hc)
                                          for p in ref[1:]]
    mvs, ly, lu, lv, rec = inter_frame.encode_p_frame(
        *_tensors(o, dev), *_tensors(r, dev), qp, s, bit_depth,
        search_range, wrap_around)
    hb = halo // s
    part = ([_host(_crop_rows(t, hb, hb)) for t in (mvs, ly, lu, lv)],
            _crop_recon(rec, halo, halo))
    return _finish(mesh, part)
