"""Multi-model motion inside the quadtree lattice (MM x partitioning).

PyTorch counterpart of `vvc_mm_tpu/common/mm/qt_codec.py` (reference:
EncCu.cpp:775-798 — the per-model mode loop at every evaluated CU).  The
per-block model search runs frame-batched at EACH node size
(mm/frame_codec), the split tree resolves bottom-up on the host, and the
winning (model, MV) pairs resolve to the UNIT grid.  MM target positions
depend only on (subblock center, MV, model), not on the partition, so one
merged-positions MC pass at unit granularity predicts the mixed-size,
mixed-model frame and the per-size residuals are added on top.
"""
from __future__ import annotations

import torch

from ..qtree import _recon
from . import frame_codec as fc
from .reprojection import MVReprojection, SUBBLK


def reconstruct_qt_mm(reproj: MVReprojection, active_models: list[int],
                      midx_unit, mv_unit, levels, ref_y, ref_u, ref_v,
                      qp: int, top: int, depth: int, bit_depth: int,
                      epipoles: dict | None = None,
                      wrap_around: bool = False, positions=None,
                      _preds=None):
    """Unit-granularity merged positions -> one MC pass -> per-size
    residual sum.  midx_unit (nuy, nux) model index, mv_unit (nuy, nux, 2)
    the selected model's MV per unit, levels one (y, u, v) trio per node
    size.  _preds: the encoder tail's already computed predictions."""
    u = top >> depth
    assert u >= SUBBLK
    dev = ref_y.device
    if _preds is not None:
        pred_y, pred_u, pred_v = _preds
    else:
        if positions is None:
            midx_unit = torch.as_tensor(midx_unit, device=dev)
            mv_unit = torch.as_tensor(mv_unit, device=dev)
            # stack with each unit's MV in its selected model's layer
            stack = fc._to_stack(midx_unit, mv_unit, len(active_models))
            positions = fc.merged_positions(reproj, active_models,
                                            midx_unit, stack, u, epipoles)
        pred_y, pred_u, pred_v = fc.predict_from_positions(
            positions, ref_y, ref_u, ref_v, bit_depth, wrap_around)

    levels = [tuple(torch.as_tensor(lev, device=dev) for lev in trio)
              for trio in levels]
    return _recon((pred_y, pred_u, pred_v), levels, qp, bit_depth)


