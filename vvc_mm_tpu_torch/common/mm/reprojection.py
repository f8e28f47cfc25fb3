"""MVReprojection — per-4x4-subblock motion reprojection, frame-batched.

PyTorch counterpart of `vvc_mm_tpu/common/mm/reprojection.py` (reference:
source/Lib/CommonLib/MVReprojection.cpp — fillCache:69-73 subblock-center
grid with offset MMOffset4x4; reprojectMotionVectorSubblocks:81 absolute
target positions; NaN -> identity :158-161; round to 1/16 pel :170-173).

Every subblock of a frame is reprojected in one elementwise pass per
(model, MV field).  The math is float32 with the JAX package's operation
order; `torch.round` rounds half to even like `jnp.round`.  The positions
are normative, but torch's (and CUDA's) sin/atan2/asin round differently
from XLA's in the last ulp, so a position that lies within a few ulp of a
1/16-pel boundary may come out one unit apart (tests/test_torch_
reprojection.py bounds how many).

Chroma (4:2:0) reuses the same integers at 1/32 chroma pel
(round(x/2*32) == round(x*16)).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import models
from ...device import resolve_device
from ..typedefs import MotionModelID as M

SUBBLK = 4       # luma subblock size (reference: MVReprojection 4x4)

_MPA = (M.MPA_FRONT_BACK, M.MPA_LEFT_RIGHT, M.MPA_TOP_BOTTOM)
_GED = (M.GEODESIC_CAMPOSE, M.GEODESIC_AXIS_X, M.GEODESIC_AXIS_Y,
        M.GEODESIC_AXIS_Z)


def offset4x4_value(code: int) -> float:
    """reference: MVReprojection.cpp:10 — code 4 means 1.5."""
    return 1.5 if code == 4 else float(code)


class MVReprojection:
    """Per-frame-geometry reprojection state on one device, CUDA unless
    another is named (caches the subblock grid, the MPA perspective-plane
    caches, the grid's folded sphere points and the GED epipole-alignment
    matrices)."""

    def __init__(self, proj, width: int, height: int,
                 offset4x4_code: int = 1, ged_flavor: int = 1,
                 device: torch.device | str | None = None) -> None:
        self.proj = proj
        self.width = width
        self.height = height
        self.device = resolve_device(device)
        self.offset = offset4x4_value(offset4x4_code)
        self.angle_res = math.pi / height
        self.ged_flavor = ged_flavor
        nsx, nsy = width // SUBBLK, height // SUBBLK
        f32 = dict(dtype=torch.float32, device=self.device)
        gx = torch.arange(nsx, **f32) * SUBBLK + self.offset
        gy = torch.arange(nsy, **f32) * SUBBLK + self.offset
        self.grid_x = gx[None, :].expand(nsy, nsx).contiguous()
        self.grid_y = gy[:, None].expand(nsy, nsx).contiguous()
        self._mpa_cache: dict[int, tuple] = {}
        self._grid_sphere: tuple | None = None
        self._ged_rot: dict[tuple, torch.Tensor] = {}

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
        JAX codec's merged positions (ERP.to_sphere_folded): computed on
        the host once, then kept on this device."""
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
        cx = (torch.arange(nbx, **f32) * block_size
              + (block_size - 1) / 2.0)
        cy = (torch.arange(nby, **f32) * block_size
              + (block_size - 1) / 2.0)
        cx = cx[None, :].expand(nby, nbx)
        cy = cy[:, None].expand(nby, nbx)
        return up(mvf[..., 0]), up(mvf[..., 1]), up(cx), up(cy)

    def reproject_frame(self, model_id: int, mvs: torch.Tensor,
                        block_size: int, epipole=None,
                        row_step: int = 1, form: str | None = None
                        ) -> torch.Tensor:
        """Model every subblock of the frame under `model_id`.

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
        mvs = mvs.to(self.device)
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
        fy = torch.round(oy * 16.0).to(torch.int32)
        return torch.stack([fx, fy], dim=-1)

    def reproject_block_centers(self, model_id: int, mvs: torch.Tensor,
                                block_size: int, epipole=None
                                ) -> torch.Tensor:
        """Block-translational search approximation: model the motion of
        each BLOCK CENTER only and return the 1/16-pel position of the
        block's top-left sample under that uniform displacement.

        Decision-only (ranks search candidates); normative paths use the
        full per-subblock reprojection (reproject_frame).

        mvs (nby, nbx, 2) int 1/16-pel -> (nby, nbx, 2) int32 positions."""
        mvs = mvs.to(self.device)
        nby, nbx = mvs.shape[:2]
        s = block_size
        f32 = dict(dtype=torch.float32, device=self.device)
        cx = torch.arange(nbx, **f32) * s + (s - 1) / 2.0
        cy = torch.arange(nby, **f32) * s + (s - 1) / 2.0
        cx = cx[None, :].expand(nby, nbx)
        cy = cy[:, None].expand(nby, nbx)
        mvf = mvs.to(torch.float32) / 16.0
        ox, oy = self._model_motion_pointwise(model_id, cx, cy,
                                              mvf[..., 0], mvf[..., 1],
                                              cx, cy, epipole)
        bad = torch.isnan(ox) | torch.isnan(oy)
        ox = torch.where(bad, cx, ox)
        oy = torch.where(bad, cy, oy)
        half = (s - 1) / 2.0
        fx = torch.round((ox - half) * 16.0).to(torch.int32)
        fy = torch.round((oy - half) * 16.0).to(torch.int32)
        return torch.stack([fx, fy], dim=-1)

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
