"""MVReprojection — per-4x4-subblock motion reprojection, frame-batched.

PyTorch counterpart of `vvc_mm_tpu/common/mm/reprojection.py` (reference:
source/Lib/CommonLib/MVReprojection.cpp — fillCache:69-73 subblock-center
grid with offset MMOffset4x4; reprojectMotionVectorSubblocks:81 absolute
target positions; NaN -> identity :158-161; round to 1/16 pel :170-173).

Every subblock of a frame is reprojected in one elementwise pass per
(model, MV field).  The math is float32 in the JAX package's operation
order and compiled form, with glibc's float32 functions copied
(common/libm_f32.py); `torch.round` rounds half to even like `jnp.round`,
so the normative positions equal the JAX package's.  `positions` and
`centers` take K fields at once and are the one way in: the port sends
MPA and ROT (with CLASSIC) through its sphere kernel on the card; this
frozen copy keeps only the float32 chain (_frame_chain, _centers_chain),
the port's CPU path.

Chroma (4:2:0) reuses the same integers at 1/32 chroma pel
(round(x/2*32) == round(x*16)).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import models
from .mc import classic_positions
from ...device import resolve_device
from ...lib360.projection import ERP
from ..typedefs import MotionModelID as M

SUBBLK = 4       # luma subblock size (reference: MVReprojection 4x4)

_MPA = (M.MPA_FRONT_BACK, M.MPA_LEFT_RIGHT, M.MPA_TOP_BOTTOM)
_GED = (M.GEODESIC_CAMPOSE, M.GEODESIC_AXIS_X, M.GEODESIC_AXIS_Y,
        M.GEODESIC_AXIS_Z)


def offset4x4_value(code: int) -> float:
    """reference: MVReprojection.cpp:10 — code 4 means 1.5."""
    return 1.5 if code == 4 else float(code)


def _up_rows(idx: torch.Tensor, rep: int, row_step: int, col_step: int
             ) -> torch.Tensor:
    """A per-block grid at the kept subblocks."""
    up = idx.repeat_interleave(rep, 0).repeat_interleave(rep, 1)
    return up[::row_step, ::col_step]


class MVReprojection:
    """Per-frame-geometry reprojection state on one device, CUDA unless
    another is named (caches the subblock grid, the MPA perspective-plane
    caches, the grid's folded sphere points and the GED epipole-alignment
    matrices).

    rows=(y0, y1) restricts it to a slab of the frame's rows (a multiple
    of the block size apart, for row-sharded encodes): the models run at
    the slab's absolute rows, `height` stays the frame's (the angle
    resolution and the search arm follow the whole frame), and every
    position it returns is relative to row y0 (the slab's own planes)."""

    def __init__(self, proj, width: int, height: int,
                 offset4x4_code: int = 1, ged_flavor: int = 1,
                 device: torch.device | str | None = None,
                 rows: tuple[int, int] | None = None) -> None:
        self.proj = proj
        self.width = width
        self.height = height
        self.offset4x4_code = offset4x4_code
        self.row0, row1 = rows if rows is not None else (0, height)
        self.rows = row1 - self.row0
        self.device = resolve_device(device)
        self.offset = offset4x4_value(offset4x4_code)
        self.angle_res = math.pi / height
        self.ged_flavor = ged_flavor
        nsx, nsy = width // SUBBLK, self.rows // SUBBLK
        f32 = dict(dtype=torch.float32, device=self.device)
        gx = torch.arange(nsx, **f32) * SUBBLK + self.offset
        gy = torch.arange(self.row0 // SUBBLK, row1 // SUBBLK,
                          **f32) * SUBBLK + self.offset
        self.grid_x = gx[None, :].expand(nsy, nsx).contiguous()
        self.grid_y = gy[:, None].expand(nsy, nsx).contiguous()
        self._mpa_cache: dict[int, tuple] = {}
        self._grid_sphere: tuple | None = None
        self._ged_rot: dict[tuple, torch.Tensor] = {}

    def slab(self, y0: int, y1: int) -> "MVReprojection":
        """The same geometry restricted to the frame's rows [y0, y1), on
        this device."""
        return MVReprojection(self.proj, self.width, self.height,
                              self.offset4x4_code, self.ged_flavor,
                              self.device, rows=(y0, y1))

    # -- caches ------------------------------------------------------------
    def mpa_cache(self, plane: int):
        """Full-frame perspective-plane cache (reference:
        MotionPlaneAdaptiveMotionModel.cpp:106 fillCache)."""
        if plane not in self._mpa_cache:
            self._mpa_cache[plane] = models.mpa_to_perspective(
                self.proj, plane, self.grid_x, self.grid_y)
        return self._mpa_cache[plane]

    def grid_sphere(self) -> tuple:
        """The subblock grid's sphere points as XLA folds them into the
        JAX codec's merged positions (the projection's to_sphere_folded):
        computed on the host once, then kept on this device."""
        if self._grid_sphere is None:
            self._grid_sphere = tuple(
                c.to(self.device) for c in self.proj.to_sphere_folded(
                    self.grid_x.cpu(), self.grid_y.cpu()))
        return self._grid_sphere

    def ged_rot(self, epipole) -> torch.Tensor:
        """The float32 epipole-alignment matrix on this device, cached by
        the epipole rounded to 9 decimals (as the JAX package keys it)."""
        key = tuple(np.round(np.asarray(epipole, dtype=np.float64), 9))
        if key not in self._ged_rot:
            self._ged_rot[key] = torch.from_numpy(
                models.ged_rotation_matrix(epipole)).to(self.device)
        return self._ged_rot[key]

    def _ged(self, model_id, epipole, gx, gy, mv_x, mv_y, c_x, c_y,
             form: str | None = None, grid_sphere=None):
        if model_id != M.GEODESIC_CAMPOSE:
            epipole = models.GEDA_EPIPOLES[M(model_id)]
        if epipole is None:
            raise ValueError("GEODESIC_CAMPOSE needs an epipole")
        rot = (models.ged_rotation_matrix(epipole) if form == "merged"
               else self.ged_rot(epipole))
        return models.ged_motion(self.proj, self.angle_res, rot,
                                 self.ged_flavor, gx, gy, mv_x, mv_y, c_x,
                                 c_y, form, grid_sphere)

    # -- the engine --------------------------------------------------------
    def _subblock_mv_center(self, mvs: torch.Tensor, block_size: int,
                            row_step: int = 1):
        """Broadcast per-block (nby, nbx, 2) 1/16-pel MVs and block centers
        to the subblock grid -> per-subblock float32 mv/center tensors.
        row_step > 1 keeps only every row_step-th subblock row (subsampled
        SAD during search)."""
        rep = block_size // SUBBLK

        def up(t):
            return t.repeat_interleave(rep, 0).repeat_interleave(
                rep, 1)[::row_step]

        mvf = mvs.to(torch.float32) / 16.0
        nby, nbx = mvs.shape[:2]
        f32 = dict(dtype=torch.float32, device=mvs.device)
        by0 = self.row0 // block_size
        cx = (torch.arange(nbx, **f32) * block_size
              + (block_size - 1) / 2.0)
        cy = (torch.arange(by0, by0 + nby, **f32) * block_size
              + (block_size - 1) / 2.0)
        cx = cx[None, :].expand(nby, nbx)
        cy = cy[:, None].expand(nby, nbx)
        return up(mvf[..., 0]), up(mvf[..., 1]), up(cx), up(cy)

    def reproject_frame(self, model_id: int, mvs: torch.Tensor,
                        block_size: int, epipole=None,
                        row_step: int = 1, form: str | None = None
                        ) -> torch.Tensor:
        """Model every subblock of the frame under `model_id`: `positions`
        of one field.

        Args:
          mvs: (nby, nbx, 2) int 1/16-pel motion vectors.
          epipole: (3,) for GEODESIC_CAMPOSE.
          row_step: keep every row_step-th subblock row only (search-time
            subsampled SAD; normative paths use 1).
          form: the float32 form XLA compiles for the JAX codec: "merged"
            (its jit of merged_positions: every sphere model), "search"
            (the merge search's candidate positions: MPA and ROT; the
            others op by op); None, op by op as the JAX package computes
            them outside a jit.
        Returns:
          (nsy, nsx, 2) int32 absolute subblock target positions, 1/16-pel
          luma fixed point.
        """
        mvs = torch.as_tensor(mvs, device=self.device)
        return self.positions([model_id], None, mvs[None, None], block_size,
                              row_step, 1, form, {model_id: epipole})[0]

    def _frame_chain(self, model_id: int, mvs: torch.Tensor,
                     block_size: int, epipole=None, row_step: int = 1,
                     form: str | None = None) -> torch.Tensor:
        """reproject_frame by the float32 chain, with its arguments and
        result (for MPA and ROT the sphere kernel's plain version)."""
        mvs = mvs.to(self.device)
        form = self._form(model_id, form)
        mv_x, mv_y, c_x, c_y = self._subblock_mv_center(mvs, block_size,
                                                        row_step)
        gx, gy = self.grid_x[::row_step], self.grid_y[::row_step]
        if model_id in _MPA:
            cache = tuple(c[::row_step] for c in self.mpa_cache(model_id))
            ox, oy = models.mpa_motion(self.proj, model_id, gx, gy, mv_x,
                                       mv_y, pers_cache=cache, form=form)
        else:
            gs = (tuple(c[::row_step] for c in self.grid_sphere())
                  if form == "merged" and model_id != M.CLASSIC else None)
            ox, oy = self._model_motion_pointwise(model_id, gx, gy, mv_x,
                                                  mv_y, c_x, c_y, epipole,
                                                  form, gs)
        # NaN -> no motion (reference: MVReprojection.cpp:158-161)
        bad = torch.isnan(ox) | torch.isnan(oy)
        ox = torch.where(bad, gx, ox) - self.offset
        oy = torch.where(bad, gy, oy) - self.offset
        fx = torch.round(ox * 16.0).to(torch.int32)
        fy = torch.round(oy * 16.0).to(torch.int32) - self.row0 * 16
        return torch.stack([fx, fy], dim=-1)

    def reproject_block_centers(self, model_id: int, mvs: torch.Tensor,
                                block_size: int, epipole=None
                                ) -> torch.Tensor:
        """Block-translational search approximation: model the motion of
        each BLOCK CENTER only and return the 1/16-pel position of the
        block's top-left sample under that uniform displacement.

        Decision-only (ranks search candidates); normative paths use the
        full per-subblock reprojection (reproject_frame).

        mvs (nby, nbx, 2) int 1/16-pel -> (nby, nbx, 2) int32 positions:
        `centers` of one field."""
        mvs = torch.as_tensor(mvs, device=self.device)
        return self.centers([model_id], None, mvs[None, None], block_size,
                            {model_id: epipole})[0]

    def _form(self, model_id: int, form: str | None) -> str | None:
        """The float32 form a model's positions take: on ERP the one asked
        for; on Equisolid the merged form of MPA, ROT, 3DT and TAN (their
        compiled form in the JAX codec's merged positions), MPA's merged
        form in the merge search too, and op by op otherwise (GED, and the
        merge search's other models)."""
        if isinstance(self.proj, ERP) or form is None:
            return form
        if model_id in _MPA:
            return form
        if model_id in (M.ROTATIONAL, M.THREE_D_TRANSLATIONAL,
                        M.TANGENTIAL, *_GED) and form == "merged":
            return form
        return None

    def _centers_chain(self, model_id: int, mvs: torch.Tensor,
                       block_size: int, epipole=None,
                       form: str | None = None) -> torch.Tensor:
        """reproject_block_centers by the float32 chain (for CLASSIC, MPA
        and ROT the sphere kernel's plain version).  form "search": the
        form XLA compiles inside the JAX codec's search jits, for MPA and
        ROT on ERP (models.mpa_center_motion_fused; ROT's merged form at
        the centre's own sphere point); None, and the other models, op by
        op."""
        mvs = mvs.to(self.device)
        nby, nbx = mvs.shape[:2]
        s = block_size
        f32 = dict(dtype=torch.float32, device=self.device)
        by0 = self.row0 // s
        cx = torch.arange(nbx, **f32) * s + (s - 1) / 2.0
        cy = torch.arange(by0, by0 + nby, **f32) * s + (s - 1) / 2.0
        cx = cx[None, :].expand(nby, nbx)
        cy = cy[:, None].expand(nby, nbx)
        mvf = mvs.to(torch.float32) / 16.0
        fused = form == "search" and isinstance(self.proj, ERP)
        if fused and model_id in _MPA:
            ox, oy = models.mpa_center_motion_fused(
                self.proj, model_id, cx, cy, mvf[..., 0], mvf[..., 1])
        elif fused and model_id == M.ROTATIONAL:
            ox, oy = models.rot_motion(
                self.proj, self.angle_res, cx, cy, mvf[..., 0],
                mvf[..., 1], cx, cy, "merged", self.proj.to_sphere(cx, cy))
        else:
            ox, oy = self._model_motion_pointwise(model_id, cx, cy,
                                                  mvf[..., 0], mvf[..., 1],
                                                  cx, cy, epipole)
        bad = torch.isnan(ox) | torch.isnan(oy)
        ox = torch.where(bad, cx, ox)
        oy = torch.where(bad, cy, oy)
        half = (s - 1) / 2.0
        fx = torch.round((ox - half) * 16.0).to(torch.int32)
        fy = torch.round((oy - half) * 16.0).to(torch.int32) - self.row0 * 16
        return torch.stack([fx, fy], dim=-1)

    # -- K fields at once (the port's sphere kernel on the card) -----------
    def positions(self, model_ids: list[int], model_idx, mvs,
                  block_size: int, row_step: int = 1, col_step: int = 1,
                  form: str | None = "merged", epipoles: dict | None = None
                  ) -> torch.Tensor:
        """Per-subblock positions of K fields, merged by model: model_idx
        (K, nby, nbx) indexes `model_ids` per block, or None (slot 0
        throughout); mvs (K, n_models, nby, nbx, 2) 1/16-pel MVs; every
        row_step-th subblock row and col_step-th column is kept; form as
        reproject_frame's; epipoles {model: epipole} for GED.  Returns
        (K, ny, nx, 2) int32 1/16-pel positions, by `positions_plain` (the
        port launches its sphere kernel here on the card)."""
        model_idx, mvs = self._fields(model_idx, mvs)
        return self.positions_plain(model_ids, model_idx, mvs, block_size,
                                    row_step, col_step, form, epipoles)

    def centers(self, model_ids: list[int], model_idx, mvs,
                block_size: int, epipoles: dict | None = None,
                form: str | None = None) -> torch.Tensor:
        """Block-centre positions of K fields, merged by model (arguments
        as `positions`'; form None op by op, "search" the JAX codec's
        search jits' form, `_centers_chain`): (K, nby, nbx, 2) int32, by
        `centers_plain` (the port launches its sphere kernel here on the
        card)."""
        model_idx, mvs = self._fields(model_idx, mvs)
        return self.centers_plain(model_ids, model_idx, mvs, block_size,
                                  epipoles, form)

    def positions_plain(self, model_ids: list[int], model_idx, mvs,
                        block_size: int, row_step: int = 1,
                        col_step: int = 1, form: str | None = "merged",
                        epipoles: dict | None = None) -> torch.Tensor:
        """`positions` by the float32 chain (the sphere kernel's plain
        version): for each field every model's positions, merged by the
        model index."""
        model_idx, mvs = self._fields(model_idx, mvs)
        _, _, rep = self._grid_dims(mvs, block_size)
        out = []
        for k in range(mvs.shape[0]):
            if model_idx is None:
                pos = self._model_positions(model_ids[0], mvs[k, 0],
                                            block_size, epipoles, row_step,
                                            form)
            else:
                pos_all = torch.stack([
                    self._model_positions(m, mvs[k, i], block_size,
                                          epipoles, row_step, form)
                    for i, m in enumerate(model_ids)])
                idx = _up_rows(model_idx[k].to(torch.int64), rep, row_step,
                               1)
                pos = torch.gather(pos_all, 0, idx[None, :, :, None].expand(
                    1, -1, -1, 2))[0]
            out.append(pos[:, ::col_step])
        return torch.stack(out)

    def centers_plain(self, model_ids: list[int], model_idx, mvs,
                      block_size: int, epipoles: dict | None = None,
                      form: str | None = None) -> torch.Tensor:
        """`centers` by the float32 chain (the sphere kernel's plain
        version)."""
        model_idx, mvs = self._fields(model_idx, mvs)
        eps = epipoles or {}
        out = []
        for k in range(mvs.shape[0]):
            if model_idx is None:
                out.append(self._centers_chain(model_ids[0], mvs[k, 0],
                                               block_size,
                                               eps.get(model_ids[0]), form))
                continue
            pos_all = torch.stack([
                self._centers_chain(m, mvs[k, i], block_size, eps.get(m),
                                    form)
                for i, m in enumerate(model_ids)])
            idx = model_idx[k].to(torch.int64)[None, :, :, None]
            out.append(torch.gather(pos_all, 0, idx.expand(1, -1, -1, 2))[0])
        return torch.stack(out)

    def _fields(self, model_idx, mvs):
        mvs = torch.as_tensor(mvs, device=self.device)
        if mvs.dim() != 5 or mvs.shape[-1] != 2:
            raise ValueError(f"mvs of shape {tuple(mvs.shape)}: expected (K, "
                             "n_models, nby, nbx, 2)")
        if model_idx is not None:
            model_idx = torch.as_tensor(model_idx, device=self.device)
            if tuple(model_idx.shape) != tuple(mvs.shape[:1]
                                               + mvs.shape[2:4]):
                raise ValueError(f"model_idx of shape "
                                 f"{tuple(model_idx.shape)} for mvs of shape "
                                 f"{tuple(mvs.shape)}")
        return model_idx, mvs

    def _grid_dims(self, mvs: torch.Tensor, block_size: int) -> tuple:
        nsy, nsx = self.rows // SUBBLK, self.width // SUBBLK
        rep = block_size // SUBBLK
        nby, nbx = mvs.shape[-3:-1]
        if (nby * rep, nbx * rep) != (nsy, nsx):
            raise ValueError(f"a ({nby}, {nbx}) field of {block_size}-blocks "
                             f"does not cover the ({nsy}, {nsx}) subblocks")
        return nsy, nsx, rep

    def _model_positions(self, model_id: int, mvs: torch.Tensor,
                         block_size: int, epipoles: dict | None,
                         row_step: int, form: str | None) -> torch.Tensor:
        """One model's positions of one (nby, nbx, 2) field on every
        subblock column, by the float32 chain (CLASSIC by its integer
        formula)."""
        if model_id == M.CLASSIC:
            return classic_positions(self.width, self.rows, mvs,
                                     block_size, row_step)
        return self._frame_chain(model_id, mvs, block_size,
                                 (epipoles or {}).get(model_id), row_step,
                                 form)

    def mv_in_desired_model(self, pos_xy, mv_orig_16th, model_orig: int,
                            model_desired: int, center_cand_xy,
                            center_cur_xy, epipole_orig=None,
                            epipole_des=None) -> torch.Tensor:
        """Candidate MV conversion between models, batched over candidates
        (reference: MVReprojection.cpp:168
        motionVectorInDesiredMotionModel — forward-map the candidate MV at
        `pos`, then the closed-form inverse in the desired model).  The
        positional arguments are (..., 2) float pixel tensors (MVs in
        1/16 pel) that broadcast together.

        Returns (..., 2) int32 1/16-pel MVs, 0 where NaN or where the
        candidate MV is zero."""
        def f32(t):
            return torch.as_tensor(t, dtype=torch.float32,
                                   device=self.device)
        pos, cc, kc = f32(pos_xy), f32(center_cand_xy), f32(center_cur_xy)
        mvf = f32(mv_orig_16th) / 16.0
        px, py = pos[..., 0], pos[..., 1]
        sx, sy = self._model_motion_pointwise(
            model_orig, px, py, mvf[..., 0], mvf[..., 1], cc[..., 0],
            cc[..., 1], epipole_orig)
        mx, my = self._mv_for_shift(model_desired, px, py, sx, sy,
                                    kc[..., 0], kc[..., 1], epipole_des)
        bad = torch.isnan(mx) | torch.isnan(my)
        zero = (mvf[..., 0] == 0) & (mvf[..., 1] == 0)
        out_x = torch.where(bad | zero, 0.0, torch.round(mx * 16.0))
        out_y = torch.where(bad | zero, 0.0, torch.round(my * 16.0))
        # an inverse can blow up (a perspective plane near its horizon):
        # values beyond int32 saturate, as XLA's float -> int32 does
        out = torch.stack([out_x, out_y], -1).to(torch.float64)
        return torch.clamp(out, -2.0 ** 31, 2.0 ** 31 - 1).to(torch.int32)

    def _model_motion_pointwise(self, model_id, px, py, mvx, mvy, cx, cy,
                                epipole, form: str | None = None,
                                grid_sphere=None):
        """One model's motion of points (px, py); form and grid_sphere as
        reproject_frame passes them (the grid's points only)."""
        p = self.proj
        if model_id == M.CLASSIC:
            return models.translational_motion(px, py, mvx, mvy)
        if model_id in _MPA:
            return models.mpa_motion(p, model_id, px, py, mvx, mvy)
        if model_id == M.THREE_D_TRANSLATIONAL:
            return models.t3d_motion(p, px, py, mvx, mvy, cx, cy, form,
                                     grid_sphere)
        if model_id == M.TANGENTIAL:
            return models.tan_motion(p, self.angle_res, px, py, mvx, mvy,
                                     cx, cy, form, grid_sphere)
        if model_id == M.ROTATIONAL:
            return models.rot_motion(p, self.angle_res, px, py, mvx, mvy,
                                     cx, cy, form, grid_sphere)
        if model_id in _GED:
            return self._ged(model_id, epipole, px, py, mvx, mvy, cx, cy,
                             form, grid_sphere)
        raise ValueError(f"unknown model {model_id}")

    def _mv_for_shift(self, model_id, px, py, sx, sy, cx, cy, epipole):
        p = self.proj
        if model_id == M.CLASSIC:
            return models.translational_mv_for_shift(px, py, sx, sy)
        if model_id in _MPA:
            return models.mpa_mv_for_shift(p, model_id, px, py, sx, sy)
        if model_id == M.THREE_D_TRANSLATIONAL:
            return models.t3d_mv_for_shift(p, px, py, sx, sy, cx, cy)
        if model_id == M.TANGENTIAL:
            return models.tan_mv_for_shift(p, self.angle_res, px, py, sx,
                                           sy, cx, cy)
        if model_id == M.ROTATIONAL:
            return models.rot_mv_for_shift(p, self.angle_res, px, py, sx,
                                           sy, cx, cy)
        if model_id not in _GED:
            raise ValueError(f"unknown model {model_id}")
        if model_id != M.GEODESIC_CAMPOSE:
            epipole = models.GEDA_EPIPOLES[M(model_id)]
        if epipole is None:
            raise ValueError("GEODESIC_CAMPOSE needs an epipole")
        return models.ged_mv_for_shift(p, self.angle_res,
                                       self.ged_rot(epipole),
                                       self.ged_flavor, px, py, sx, sy, cx,
                                       cy)
