"""L1, redesigned: the launcher of MPA's and ROT's sphere-positions kernel
(csrc/sphere_positions.cu), hand-written CUDA for Hopper, one launch a
call.

  sphere_positions  per-subblock positions of K MV fields (each a stack of
                    per-model MV layers and a per-block model index), in
                    the float32 form the launch's template names: op by op,
                    the merged positions' jit or the merge search's;
                    CLASSIC is integer math.
  sphere_centers    block-centre positions of K fields, op by op (the
                    decision arm at 512 rows and more).

Both replace no Pallas kernel: the JAX package computes these positions in
float32 code that XLA's CPU backend compiles, calling glibc's float32
sinf/cosf/tanf/atan2f (kernel L1's elementwise entry points,
ops/libm_kernel.py, copy those; the kernel here runs them whole).

This module takes tensors and a launch template only.  The entry point
that splits the models, fills 3DT's, TAN's and GED's positions by the
chain, builds the template from the reprojection and holds the plain
versions (the port's float32 chain looped over fields and models) is
`MVReprojection.positions` / `MVReprojection.centers`
(common/mm/reprojection.py): it calls `launch` on the card and the plain
version on the CPU.  `LAUNCHES` counts launches (a group of
utils/profiling.py's counter registry).
"""
from __future__ import annotations

import ctypes

import torch

from ..common.typedefs import MotionModelID as M
from ..utils import profiling
from . import cuda_lib

# the models the kernel computes; any other model keeps the float32 chain
KERNEL_MODELS = (M.CLASSIC, M.MPA_FRONT_BACK, M.MPA_LEFT_RIGHT,
                 M.MPA_TOP_BOTTOM, M.ROTATIONAL)
FORMS = {None: 0, "merged": 1, "search": 2}
MAX_MODELS = 8
SKIP = -1

LAUNCHES = profiling.counters("sphere_kernel",
                              ("sphere_positions", "sphere_centers"))
# launches by form, model count, field count and output grid, e.g.
# "merged m=5 K=1 256x512"
LAUNCHES_BY_SHAPE: dict[str, dict[str, int]] = profiling.counters(
    "sphere_kernel.by_shape")
LAUNCHES_BY_SHAPE.update(sphere_positions={}, sphere_centers={})

# the kernel's Consts, in order: each the float32 value of a Python scalar
# of the plain chain
CONST_NAMES = ("offset", "po", "width", "height", "pi", "two_pi", "half_pi",
               "angle_res", "focal", "focal_recip", "neg_recip_2pi",
               "y_scale", "persp_c", "half")


class _Consts(ctypes.Structure):
    _fields_ = [(n, ctypes.c_float) for n in CONST_NAMES]


_P4 = ctypes.c_void_p * MAX_MODELS


class _Args(ctypes.Structure):
    _fields_ = [("mvs", ctypes.c_void_p), ("midx", ctypes.c_void_p),
                ("rsqrt_tab", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("ga", _P4), ("gb", _P4), ("gc", _P4), ("vip", _P4),
                ("code", ctypes.c_int * MAX_MODELS)] + [
        (n, ctypes.c_int) for n in ("n_models", "k", "nby", "nbx", "bs",
                                    "row_step", "col_step", "ny", "nx",
                                    "grid_w", "form", "sy0")] + [
        ("c", _Consts)]


_BOUND: dict = {}
_FORM_NAMES = {v: k for k, v in FORMS.items()}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for d in LAUNCHES_BY_SHAPE.values():
        d.clear()


def template(codes: list[int], grids: list, rsqrt_tab: torch.Tensor,
             consts: dict[str, float], block_size: int, grid_w: int,
             form: str | None, sy0: int = 0) -> _Args:
    """The part of a launch's Args that stays from call to call: each model
    slot's code (SKIP for a model the kernel leaves to the chain) and grid
    constants (None, or the MPA cache's (px, py, vip) or ROT's folded
    (x, y, z), each (nsy, nsx) on the card), the rsqrt table, the
    constants, the block size, the subblock grid's width, the form and
    sy0, the subblock row of the frame that the grid's row 0 is (a row
    slab's; its positions come out relative to it).
    The caller keeps the tensors alive for as long as the template."""
    if len(codes) > MAX_MODELS:
        raise ValueError(f"{len(codes)} models: the kernel takes at most "
                         f"{MAX_MODELS}")
    if form not in FORMS:
        raise ValueError(f"form {form!r}")
    args = _Args()
    args.rsqrt_tab = rsqrt_tab.data_ptr()
    for i, (code, grid) in enumerate(zip(codes, grids)):
        args.code[i] = code
        if grid is not None:
            args.ga[i], args.gb[i] = grid[0].data_ptr(), grid[1].data_ptr()
            if grid[2].dtype == torch.bool:
                args.vip[i] = grid[2].data_ptr()
            else:
                args.gc[i] = grid[2].data_ptr()
    args.n_models, args.bs = len(codes), block_size
    args.grid_w, args.form, args.sy0 = grid_w, FORMS[form], sy0
    for c in CONST_NAMES:
        setattr(args.c, c, consts[c])
    return args


def _bound(name: str):
    """The ctypes function of a C entry point of sphere_positions.cu, bound
    once (the library's Args layout checked against _Args first)."""
    fn = _BOUND.get(name)
    if fn is None:
        lib = cuda_lib.load("sphere_positions")
        size = lib.sphere_args_size()
        if size != ctypes.sizeof(_Args):
            raise RuntimeError(f"sphere_positions.cu's Args is {size} bytes, "
                               f"the wrapper's {ctypes.sizeof(_Args)}")
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BOUND[name] = fn
    return fn


def launch(name: str, tmpl: _Args, model_idx: torch.Tensor | None,
           mvs: torch.Tensor, out: torch.Tensor, row_step: int = 1,
           col_step: int = 1) -> None:
    """One launch of `name` ("sphere_positions" or "sphere_centers") on the
    card: mvs (K, n_models, nby, nbx, 2) 1/16-pel MVs, model_idx (K, nby,
    nbx) model slots or None (slot 0 throughout), out (K, ny, nx, 2) int32,
    which it writes except where a slot's code is SKIP; the rest from
    `tmpl` (`template`).  Raises off the card or on a failed launch."""
    if out.device.type != "cuda" or mvs.device != out.device:
        raise ValueError(f"{name} runs on a CUDA device: out on "
                         f"{out.device}, mvs on {mvs.device}")
    args = _Args.from_buffer_copy(tmpl)
    mvs32 = mvs.to(torch.int32).contiguous()
    idx32 = None if model_idx is None else \
        model_idx.to(torch.int32).contiguous()
    args.mvs, args.out = mvs32.data_ptr(), out.data_ptr()
    args.midx = None if idx32 is None else idx32.data_ptr()
    args.k, _, args.nby, args.nbx = mvs.shape[:4]
    args.ny, args.nx = out.shape[1:3]
    args.row_step, args.col_step = row_step, col_step
    fn = _bound(name)
    if out.device.index == torch.cuda.current_device():
        err = fn(ctypes.byref(args), torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(out.device):
            err = fn(ctypes.byref(args),
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    profiling.launch(LAUNCHES, name)
    k, n = mvs.shape[:2]
    ny, nx = out.shape[1:3]
    form = _FORM_NAMES[tmpl.form]
    shape = (f"{'op' if form is None else form} " if name ==
             "sphere_positions" else "") + f"m={n} K={k} {ny}x{nx}"
    by = LAUNCHES_BY_SHAPE[name]
    by[shape] = by.get(shape, 0) + 1
