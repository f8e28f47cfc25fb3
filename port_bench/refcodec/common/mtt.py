"""Multi-type-tree (QT + BT + TT) inter partitioning — the full QTMT
lattice.

PyTorch counterpart of `vvc_mm_tpu/common/mtt.py` (reference:
UnitPartitioner.h:56-64 CU_QUAD_SPLIT, CU_HORZ_SPLIT, CU_VERT_SPLIT,
CU_TRIH_SPLIT, CU_TRIV_SPLIT, driven by EncCu::xCompressCU EncCu.cpp:499 /
xCheckModeSplit EncCu.cpp:1118).  Every node of the split lattice is
evaluated for the whole frame at once (common/qtree.py) and the tree is
resolved by a batched bottom-up argmin over SIX candidates per square
node: leaf, quad split, horizontal/vertical binary split (rectangular
halves), horizontal/vertical ternary split (1/4-1/2-1/4 stripes).

Binary and ternary children are terminal leaves, and a split kind is only
offered when its stripes stay unit-aligned (BT needs s/2 >= unit, TT needs
s/4 >= unit).  Ternary middle stripes sit at an s/4 offset from the node
grid; they are evaluated on an s/4-cropped frame so that every batched
pass runs on an aligned grid.  The winning tree is resolved to a unit-grid
MV field that drives ONE motion-compensation pass, and the per-shape
residual grids (zeroed off-leaf) are inverse-transformed and summed.

The costs are float32 with the JAX package's XLA CPU numerics (see
common/qtree.py).  Its MTT encoders are not jitted programs: their costs
are computed operation by operation, each product and sum rounded on its
own (`fused=False`), and the six-way argmin takes the first of equal
costs.
"""
from __future__ import annotations

import numpy as np
import torch

from .inter_frame import mc_predict
from .qtree import _pred_b, _recon, node_sizes

# split codes per square node (stored in the `codes` grids)
LEAF, QUAD, BTH, BTV, TTH, TTV = 0, 1, 2, 3, 4, 5
# the split code each rectangular grid belongs to
KIND_CODE = {"bth": BTH, "btv": BTV, "tth_o": TTH, "tth_m": TTH,
             "ttv_o": TTV, "ttv_m": TTV}


def bt_allowed(s: int, u: int) -> bool:
    return s // 2 >= u


def tt_allowed(s: int, u: int) -> bool:
    return s // 4 >= u


def rect_shapes(top: int, depth: int):
    """Canonical rectangular-entry list [(kind, d, sy, sx, y_off, x_off)]
    shared by encoder, decoder, and the reconstruction level layout."""
    sizes = node_sizes(top, depth)
    u = sizes[-1]
    out = []
    for d in range(depth):
        s = sizes[d]
        if bt_allowed(s, u):
            out.append(("bth", d, s // 2, s, 0, 0))
            out.append(("btv", d, s, s // 2, 0, 0))
        if tt_allowed(s, u):
            out.append(("tth_o", d, s // 4, s, 0, 0))
            out.append(("tth_m", d, s // 2, s, s // 4, 0))
            out.append(("ttv_o", d, s, s // 4, 0, 0))
            out.append(("ttv_m", d, s, s // 2, 0, s // 4))
    return out


def rect_grid(h: int, w: int, info) -> tuple[int, int]:
    """(rows, cols) of a shape's grid over an (h, w) frame."""
    _, _, sy, sx, y_off, x_off = info
    return (h - 2 * y_off) // sy, (w - 2 * x_off) // sx


# ------------------------------------------------------------------ MC


# ------------------------------------------------- rect pass evaluation


# ----------------------------------------------------------- resolve


def _rect_recon_args(rect_levels, shapes):
    return [(rect_levels[(i[0], i[1])], (i[4], i[5])) for i in shapes]


def reconstruct_mtt(mv_unit, sq_levels, rect_levels, ref_y, ref_u, ref_v,
                    qp: int, top: int, depth: int, bit_depth: int,
                    wrap_around: bool):
    """Shared enc/dec reconstruction: unit-grid MC + residual sum over all
    shape grids (P slices).  rect_levels: dict keyed like rect_shapes."""
    pred = mc_predict(ref_y, ref_u, ref_v, mv_unit, top >> depth, bit_depth,
                      wrap_around)
    return _recon(pred, sq_levels, qp, bit_depth,
                  _rect_recon_args(rect_levels, rect_shapes(top, depth)))


def reconstruct_mtt_b(mv0_unit, mv1_unit, dirs_unit, sq_levels,
                      rect_levels, ref0, ref1, qp: int, top: int,
                      depth: int, bit_depth: int, wrap_around: bool):
    """B-slice reconstruction: per-unit uni/bi combine + residual sum."""
    pred = _pred_b(ref0, ref1, mv0_unit, mv1_unit, dirs_unit, top >> depth,
                   bit_depth, wrap_around)
    return _recon(pred, sq_levels, qp, bit_depth,
                  _rect_recon_args(rect_levels, rect_shapes(top, depth)))


# ------------------------------------------------------- frame encoders


