"""K1-K6: position-based MC and decision SADs, hand-written CUDA for Hopper.

Every multi-model P/B reconstruction predicts each 4x4 luma subblock (2x2
chroma, 4:2:0) from its own absolute position: 1/16 pel for luma, the same
integers read as 1/32 pel at chroma resolution.  The motion search ranks its
candidates with SADs of such predictions.

  K1 mc_luma_positions   replaces vvc_mm_tpu/ops/mc_kernel.py
                         mc_luma_positions (_mc_luma_kernel).
  K2 mc_chroma_positions replaces vvc_mm_tpu/ops/mc_kernel.py
                         mc_chroma_positions (_mc_chroma_kernel).
  K3 sad_block_positions replaces sad_block_positions_multi: for K
                         candidate fields, the SAD of each block's first
                         4-row band predicted at one position per block.
  K4 mc_block_positions  replaces mc_block_positions_multi: K3's band
                         prediction, samples written instead of SADs.
  K5 sad_luma_positions  replaces sad_luma_positions_multi: for K fields,
                         K1's per-subblock prediction fused with the SAD
                         against the original.
  K6 sad_bilinear_positions replaces sad_bilinear_positions_multi: K5
                         with the 2-tap bilinear filter on a 5x5 patch,
                         the cheap SAD that only ranks candidates.

K1/K2 live in csrc/mc_positions.cu, K3-K6 in csrc/sad_positions.cu.  Each
reads the padded reference plane, the positions (and the original) once and
writes its result; K3 and K5 are bound by their integer multiply-adds at the
codec's shapes, the others by that memory traffic.  Each is one thread (K3/K4:
a few threads) per item, filtering in registers from aligned 16-byte loads;
design notes in the sources.

Beside each kernel sits its plain PyTorch version, ported from the JAX
package's XLA mirror (`common/mm/mc.py` _mc_luma_positions_xla /
_mc_chroma_positions_xla, sad_block_positions_xla, mc_block_positions_xla,
the loop of sad_positions_multi and sad_bilinear_positions_xla).  The wrapper takes the plain version only for a
reference plane that lies on the CPU; for a CUDA tensor it launches the
kernel or raises.  `LAUNCHES` counts kernel launches, per kernel (a group
of utils/profiling.py's counter registry).
"""
from __future__ import annotations

import ctypes

import torch

from ..common import interp
from ..common.typedefs import NTAPS_CHROMA, NTAPS_LUMA
from ..utils import profiling
from . import cuda_lib

LAUNCHES = profiling.counters("mc_kernel", (
    "mc_luma_positions", "mc_chroma_positions", "sad_block_positions",
    "mc_block_positions", "sad_luma_positions", "sad_bilinear_positions"))
# K1/K2 launches by subblock grid, e.g. "256x512" ("one row": a list of
# subblocks, as projected DMVR's bilateral costs take); K3/K4's by block
# width and candidate count, e.g. "s=8 K=5"; K5's by field count and
# subblock grid, e.g. "K=5 8x32"
LAUNCHES_BY_SHAPE: dict[str, dict[str, int]] = profiling.counters(
    "mc_kernel.by_shape")
LAUNCHES_BY_SHAPE.update({k: {} for k in (
    "mc_luma_positions", "mc_chroma_positions", "sad_block_positions",
    "mc_block_positions", "sad_luma_positions")})

_P, _I = ctypes.c_void_p, ctypes.c_int
# (source, C argument types) of each kernel's launcher; the last argument
# is the stream
_KERNELS = {
    "mc_luma_positions": ("mc_positions", [_P, _I, _I, _P, _I, _I, _I, _I,
                                           _P, _P]),
    "mc_chroma_positions": ("mc_positions", [_P, _I, _I, _P, _I, _I, _I, _I,
                                             _P, _P]),
    "sad_block_positions": ("sad_positions", [_P, _I, _I, _P, _P, _I, _I, _I,
                                              _I, _I, _I, _P, _P]),
    "mc_block_positions": ("sad_positions", [_P, _I, _I, _P, _I, _I, _I, _I,
                                             _I, _I, _P, _P]),
    "sad_luma_positions": ("sad_positions", [_P, _I, _I, _P, _P, _I, _I, _I,
                                             _I, _I, _P, _P]),
    "sad_bilinear_positions": ("sad_positions", [_P, _I, _I, _P, _P, _I, _I,
                                                 _I, _I, _P, _P]),
}
_BOUND: dict = {}


# When a dict, the kernels' wrappers keep the tensors of their last launch
# in it, keyed by (kernel, positions shape, block width or None): a timing
# run replays a kernel on the inputs the encoder really gave it.
CAPTURED: dict | None = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for d in LAUNCHES_BY_SHAPE.values():
        d.clear()


def _launch_kernel(name: str, device: torch.device, *args) -> None:
    """Launch `name` on `device`'s current stream with `args` (the stream
    is appended), raise if the launch was refused, count it.  The ctypes
    function is bound with its argument types once."""
    fn = _BOUND.get(name)
    if fn is None:
        source, argtypes = _KERNELS[name]
        fn = getattr(cuda_lib.load(source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _BOUND[name] = fn
    if device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    profiling.launch(LAUNCHES, name)


def _assemble(blocks: torch.Tensor, nsy: int, nsx: int, s: int
              ) -> torch.Tensor:
    return (blocks.reshape(nsy, nsx, s, s).permute(0, 2, 1, 3)
            .reshape(nsy * s, nsx * s))


# ---------------------------------------------------------------------------
# Plain versions (the arithmetic the kernels must reproduce bit for bit)
# ---------------------------------------------------------------------------
def mc_luma_positions_plain(ref_padded: torch.Tensor, positions: torch.Tensor,
                            margin: int, bit_depth: int = 8) -> torch.Tensor:
    """(H+2m, W+2m) int32 padded reference + (nsy, nsx, 2) int32 1/16-pel
    subblock positions -> (4*nsy, 4*nsx) int32 prediction."""
    nsy, nsx, _ = positions.shape
    pos = positions.reshape(-1, 2)
    xi = (pos[:, 0] >> 4) + margin - (NTAPS_LUMA // 2 - 1)
    yi = (pos[:, 1] >> 4) + margin - (NTAPS_LUMA // 2 - 1)
    xi = torch.clamp(xi, 0, ref_padded.shape[1] - (4 + NTAPS_LUMA - 1))
    yi = torch.clamp(yi, 0, ref_padded.shape[0] - (4 + NTAPS_LUMA - 1))
    patch = interp.gather_patches_t(ref_padded, yi, xi, 4 + NTAPS_LUMA - 1,
                                    4 + NTAPS_LUMA - 1)
    val = interp.interp_luma_t(patch, pos[:, 0] & 15, pos[:, 1] & 15, 4, 4,
                               bit_depth)
    pix = interp.finalize_uni(val, bit_depth)          # (4, 4, B)
    return _assemble(pix.permute(2, 0, 1), nsy, nsx, 4)


def mc_chroma_positions_plain(ref_padded: torch.Tensor,
                              positions: torch.Tensor, margin: int,
                              bit_depth: int = 8) -> torch.Tensor:
    """Chroma (4:2:0): the same positions at 1/32 pel over 2x2 subblocks
    -> (2*nsy, 2*nsx) int32."""
    nsy, nsx, _ = positions.shape
    pos = positions.reshape(-1, 2)
    xi = (pos[:, 0] >> 5) + margin - (NTAPS_CHROMA // 2 - 1)
    yi = (pos[:, 1] >> 5) + margin - (NTAPS_CHROMA // 2 - 1)
    xi = torch.clamp(xi, 0, ref_padded.shape[1] - (2 + NTAPS_CHROMA - 1))
    yi = torch.clamp(yi, 0, ref_padded.shape[0] - (2 + NTAPS_CHROMA - 1))
    patch = interp.gather_patches_t(ref_padded, yi, xi, 2 + NTAPS_CHROMA - 1,
                                    2 + NTAPS_CHROMA - 1)
    val = interp.interp_chroma_t(patch, pos[:, 0] & 31, pos[:, 1] & 31, 2, 2,
                                 bit_depth)
    pix = interp.finalize_uni(val, bit_depth)          # (2, 2, B)
    return _assemble(pix.permute(2, 0, 1), nsy, nsx, 2)


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------
def _launch(name: str, s: int, ref_padded: torch.Tensor,
            positions: torch.Tensor, margin: int, bit_depth: int
            ) -> torch.Tensor:
    if ref_padded.dtype != torch.int32 or positions.dtype != torch.int32:
        raise TypeError(f"{name}: int32 reference and positions required, "
                        f"got {ref_padded.dtype} / {positions.dtype}")
    if positions.device != ref_padded.device:
        raise ValueError(f"{name}: reference and positions on different "
                         "devices")
    if ref_padded.dim() != 2 or positions.dim() != 3 \
            or positions.shape[2] != 2:
        raise ValueError(f"{name}: shapes {tuple(ref_padded.shape)} / "
                         f"{tuple(positions.shape)}")
    taps = NTAPS_LUMA if s == 4 else NTAPS_CHROMA
    hp, wp = ref_padded.shape
    if hp < s + taps - 1 or wp < s + taps - 1 or not 8 <= bit_depth <= 14:
        raise ValueError(f"{name}: plane {hp}x{wp} / bit depth {bit_depth}")
    nsy, nsx, _ = positions.shape
    ref_c = ref_padded.contiguous()
    pos_c = positions.contiguous()
    if pos_c.data_ptr() % 8:             # read as one int2 a subblock
        pos_c = pos_c.clone()
    out = torch.empty((nsy * s, nsx * s), dtype=torch.int32,
                      device=ref_padded.device)
    if out.numel() == 0:
        return out
    _launch_kernel(name, ref_padded.device, ref_c.data_ptr(), hp, wp,
                   pos_c.data_ptr(), nsy, nsx, margin, bit_depth,
                   out.data_ptr())
    shapes = LAUNCHES_BY_SHAPE[name]
    key = f"{nsy}x{nsx}" if nsy > 1 else "one row"    # a list of subblocks
    shapes[key] = shapes.get(key, 0) + 1
    if CAPTURED is not None:
        CAPTURED[(name, tuple(positions.shape), None)] = dict(
            ref_padded=ref_c, positions=pos_c, orig=None, margin=margin,
            s=None, bit_depth=bit_depth)
    return out


def mc_luma_positions(ref_padded: torch.Tensor, positions: torch.Tensor,
                      margin: int, bit_depth: int = 8) -> torch.Tensor:
    """K1.  CPU tensors take the plain version; CUDA tensors the kernel."""
    if ref_padded.device.type == "cpu":
        return mc_luma_positions_plain(ref_padded, positions, margin,
                                       bit_depth)
    return _launch("mc_luma_positions", 4, ref_padded, positions, margin,
                   bit_depth)


def mc_chroma_positions(ref_padded: torch.Tensor, positions: torch.Tensor,
                        margin: int, bit_depth: int = 8) -> torch.Tensor:
    """K2.  CPU tensors take the plain version; CUDA tensors the kernel."""
    if ref_padded.device.type == "cpu":
        return mc_chroma_positions_plain(ref_padded, positions, margin,
                                         bit_depth)
    return _launch("mc_chroma_positions", 2, ref_padded, positions, margin,
                   bit_depth)


# ---------------------------------------------------------------------------
# K3 / K4 / K5: the search's decision SADs
# ---------------------------------------------------------------------------
def _band_pixels(ref_padded: torch.Tensor, positions: torch.Tensor,
                 margin: int, s: int, bit_depth: int) -> torch.Tensor:
    """(K, nby, nbx, 2) block positions -> (4, s, K*nby*nbx) predicted
    first-band samples of every (candidate, block)."""
    pos = positions.reshape(-1, 2)
    xi = (pos[:, 0] >> 4) + margin - (NTAPS_LUMA // 2 - 1)
    yi = (pos[:, 1] >> 4) + margin - (NTAPS_LUMA // 2 - 1)
    xi = torch.clamp(xi, 0, ref_padded.shape[1] - (s + NTAPS_LUMA - 1))
    yi = torch.clamp(yi, 0, ref_padded.shape[0] - (4 + NTAPS_LUMA - 1))
    patch = interp.gather_patches_t(ref_padded, yi, xi, 4 + NTAPS_LUMA - 1,
                                    s + NTAPS_LUMA - 1)   # (11, s+7, B)
    val = interp.interp_luma_t(patch, pos[:, 0] & 15, pos[:, 1] & 15, 4, s,
                               bit_depth)
    return interp.finalize_uni(val, bit_depth)            # (4, s, B)


def sad_block_positions_plain(ref_padded: torch.Tensor,
                              orig_bands: torch.Tensor,
                              positions: torch.Tensor, margin: int, s: int,
                              bit_depth: int = 8) -> torch.Tensor:
    """Per-BLOCK decision SADs of each block's first 4-pixel row band
    sampled at the block-translational position (exact 8-tap filter).
    positions (K, nby, nbx, 2); orig_bands (nby*4, nbx*s) ->
    (K, nby, nbx) int32."""
    k, nby, nbx, _ = positions.shape
    pix = _band_pixels(ref_padded, positions, margin, s, bit_depth)
    ob = orig_bands.reshape(nby, 4, nbx, s).permute(1, 3, 0, 2)
    ob = ob.reshape(4, s, nby * nbx).repeat(1, 1, k)
    return (pix - ob).abs().sum(dim=(0, 1)).reshape(k, nby, nbx) \
        .to(torch.int32)


def mc_block_positions_plain(ref_padded: torch.Tensor,
                             positions: torch.Tensor, margin: int, s: int,
                             bit_depth: int = 8) -> torch.Tensor:
    """Each block's predicted first 4-pixel row band at the
    block-translational position.  positions (K, nby, nbx, 2) ->
    (K, nby*4, nbx*s) int32."""
    k, nby, nbx, _ = positions.shape
    pix = _band_pixels(ref_padded, positions, margin, s, bit_depth)
    pix = pix.permute(2, 0, 1).reshape(k, nby, nbx, 4, s)
    return pix.permute(0, 1, 3, 2, 4).reshape(k, nby * 4, nbx * s)


def sad_luma_positions_plain(ref_padded: torch.Tensor, orig: torch.Tensor,
                             positions: torch.Tensor, margin: int,
                             bit_depth: int = 8) -> torch.Tensor:
    """Exact (8-tap) per-subblock SAD for K candidate fields: one K1-style
    prediction per field, reduced over 4x4 subblocks.  orig (4*nsy, 4*nsx),
    positions (K, nsy, nsx, 2) -> (K, nsy, nsx) int32."""
    outs = []
    for i in range(positions.shape[0]):
        pred = mc_luma_positions_plain(ref_padded, positions[i], margin,
                                       bit_depth)
        d = (orig - pred).abs()
        h, w = d.shape
        outs.append(d.reshape(h // 4, 4, w // 4, 4).sum(dim=(1, 3)))
    return torch.stack(outs).to(torch.int32)


def sad_bilinear_positions_plain(ref_padded: torch.Tensor,
                                 orig: torch.Tensor, positions: torch.Tensor,
                                 margin: int) -> torch.Tensor:
    """Per-4x4-subblock decision SADs with 2-tap bilinear interpolation for
    K candidate fields (ranks search candidates only): a 5x5 patch at the
    floor position, no clip to the bit depth.  orig (4*nsy, 4*nsx),
    positions (K, nsy, nsx, 2) -> (K, nsy, nsx) int32."""
    k, nsy, nsx, _ = positions.shape
    pos = positions.reshape(-1, 2)
    xi = torch.clamp((pos[:, 0] >> 4) + margin, 0, ref_padded.shape[1] - 5)
    yi = torch.clamp((pos[:, 1] >> 4) + margin, 0, ref_padded.shape[0] - 5)
    patch = interp.gather_patches_t(ref_padded, yi, xi, 5, 5)   # (5, 5, B)
    fx = (pos[:, 0] & 15)[None, None, :]
    fy = (pos[:, 1] & 15)[None, None, :]
    h = (patch[:, 0:4] * (16 - fx) + patch[:, 1:5] * fx + 8) >> 4
    pix = (h[0:4] * (16 - fy) + h[1:5] * fy + 8) >> 4           # (4, 4, B)
    ob = orig.reshape(nsy, 4, nsx, 4).permute(1, 3, 0, 2)
    ob = ob.reshape(4, 4, nsy * nsx).repeat(1, 1, k)
    return (pix - ob).abs().sum(dim=(0, 1)).reshape(k, nsy, nsx) \
        .to(torch.int32)


def _check_i32(name: str, ref_padded: torch.Tensor, *others: torch.Tensor
               ) -> None:
    for t in (ref_padded, *others):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: int32 tensors required, got {t.dtype}")
        if t.device != ref_padded.device:
            raise ValueError(f"{name}: tensors on different devices")


_BAND_ROWS = 4 + NTAPS_LUMA - 1      # rows an 8-tap filter reads for 4 rows


def _launch_search(name: str, ref_padded: torch.Tensor, positions:
                   torch.Tensor, out_shape: tuple, win: tuple, margin: int,
                   bit_depth: int | None, orig: torch.Tensor | None,
                   s: int | None) -> torch.Tensor:
    """Launch one of csrc/sad_positions.cu's kernels.  `orig` is the
    original band plane / plane (None for K4), `s` the block width (None
    for K5 and K6), `bit_depth` None for K6 (which does not clip), `win`
    the (rows, columns) window the plane must hold."""
    others = (positions,) if orig is None else (positions, orig)
    _check_i32(name, ref_padded, *others)
    if ref_padded.dim() != 2 or positions.dim() != 4 \
            or positions.shape[3] != 2 or positions.shape[0] < 1:
        raise ValueError(f"{name}: shapes {tuple(ref_padded.shape)} / "
                         f"{tuple(positions.shape)}")
    hp, wp = ref_padded.shape
    if hp < win[0] or wp < win[1] or \
            (bit_depth is not None and not 8 <= bit_depth <= 14):
        raise ValueError(f"{name}: plane {hp}x{wp} / bit depth {bit_depth}")
    k, ny, nx, _ = positions.shape
    out = torch.empty(out_shape, dtype=torch.int32, device=ref_padded.device)
    if out.numel() == 0:
        return out
    ref_c = ref_padded.contiguous()
    pos_c = positions.contiguous()
    if s is None and pos_c.data_ptr() % 8:   # K5/K6 read one int2 an item
        pos_c = pos_c.clone()
    args = [ref_c.data_ptr(), hp, wp]
    if orig is not None:
        orig_c = orig.contiguous()
        if orig_c.data_ptr() % 16:       # read 16 bytes at a time
            orig_c = orig_c.clone()
        args.append(orig_c.data_ptr())
    args += [pos_c.data_ptr(), k, ny, nx]
    if s is not None:
        args.append(s)
    args.append(margin)
    if bit_depth is not None:
        args.append(bit_depth)
    args.append(out.data_ptr())
    _launch_kernel(name, ref_padded.device, *args)
    shapes = LAUNCHES_BY_SHAPE.get(name)
    if shapes is not None:
        key = f"s={s} K={k}" if s is not None else f"K={k} {ny}x{nx}"
        shapes[key] = shapes.get(key, 0) + 1
    if CAPTURED is not None:
        CAPTURED[(name, tuple(positions.shape), s)] = dict(
            ref_padded=ref_c, positions=pos_c, orig=orig, margin=margin,
            s=s, bit_depth=bit_depth)
    return out


def _check_band(name: str, ref_padded: torch.Tensor,
                positions: torch.Tensor, s: int) -> None:
    """K3/K4 take block widths that are multiples of 4 up to 512, and
    index in 32 bits."""
    if s % 4 or not 4 <= s <= 512:
        raise ValueError(f"{name}: block width {s} is not a multiple of 4 "
                         "in [4, 512]")
    k, nby, nbx, _ = positions.shape
    if max(ref_padded.numel(), k * nby * 4 * nbx * s) >= 1 << 31 \
            or nby > 65535:
        raise ValueError(f"{name}: {tuple(ref_padded.shape)} plane, "
                         f"{tuple(positions.shape)} positions at s={s} do "
                         "not fit the kernel's 31-bit indices")


def _check_sub(name: str, ref_padded: torch.Tensor,
               positions: torch.Tensor) -> None:
    """K5/K6 index in 32 bits."""
    k, nsy, nsx, _ = positions.shape
    if max(ref_padded.numel(), 2 * k * nsy * nsx, 16 * nsy * nsx) \
            >= 1 << 31 or nsy > 65535:
        raise ValueError(f"{name}: {tuple(ref_padded.shape)} plane, "
                         f"{tuple(positions.shape)} positions do not fit "
                         "the kernel's 31-bit indices")


def sad_block_positions(ref_padded: torch.Tensor, orig_bands: torch.Tensor,
                        positions: torch.Tensor, margin: int, s: int,
                        bit_depth: int = 8) -> torch.Tensor:
    """K3.  CPU tensors take the plain version; CUDA tensors the kernel.
    Returns raw band SADs (K, nby, nbx); scaling to full-block range is
    the caller's."""
    if ref_padded.device.type == "cpu":
        return sad_block_positions_plain(ref_padded, orig_bands, positions,
                                         margin, s, bit_depth)
    k, nby, nbx, _ = positions.shape
    if tuple(orig_bands.shape) != (nby * 4, nbx * s):
        raise ValueError(f"sad_block_positions: bands "
                         f"{tuple(orig_bands.shape)} for {nby}x{nbx} blocks "
                         f"of width {s}")
    _check_band("sad_block_positions", ref_padded, positions, s)
    return _launch_search("sad_block_positions", ref_padded, positions,
                          (k, nby, nbx), (_BAND_ROWS, s + NTAPS_LUMA - 1),
                          margin,
                          bit_depth, orig_bands, s)


def mc_block_positions(ref_padded: torch.Tensor, positions: torch.Tensor,
                       margin: int, s: int, bit_depth: int = 8
                       ) -> torch.Tensor:
    """K4.  CPU tensors take the plain version; CUDA tensors the kernel."""
    if ref_padded.device.type == "cpu":
        return mc_block_positions_plain(ref_padded, positions, margin, s,
                                        bit_depth)
    k, nby, nbx, _ = positions.shape
    _check_band("mc_block_positions", ref_padded, positions, s)
    return _launch_search("mc_block_positions", ref_padded, positions,
                          (k, nby * 4, nbx * s),
                          (_BAND_ROWS, s + NTAPS_LUMA - 1), margin,
                          bit_depth, None, s)


def sad_luma_positions(ref_padded: torch.Tensor, orig: torch.Tensor,
                       positions: torch.Tensor, margin: int,
                       bit_depth: int = 8) -> torch.Tensor:
    """K5.  CPU tensors take the plain version; CUDA tensors the kernel."""
    if ref_padded.device.type == "cpu":
        return sad_luma_positions_plain(ref_padded, orig, positions, margin,
                                        bit_depth)
    k, nsy, nsx, _ = positions.shape
    if tuple(orig.shape) != (nsy * 4, nsx * 4):
        raise ValueError(f"sad_luma_positions: original "
                         f"{tuple(orig.shape)} for {nsy}x{nsx} subblocks")
    _check_sub("sad_luma_positions", ref_padded, positions)
    return _launch_search("sad_luma_positions", ref_padded, positions,
                          (k, nsy, nsx), (_BAND_ROWS, _BAND_ROWS), margin,
                          bit_depth, orig, None)


def sad_bilinear_positions(ref_padded: torch.Tensor, orig: torch.Tensor,
                           positions: torch.Tensor, margin: int
                           ) -> torch.Tensor:
    """K6.  CPU tensors take the plain version; CUDA tensors the kernel."""
    if ref_padded.device.type == "cpu":
        return sad_bilinear_positions_plain(ref_padded, orig, positions,
                                            margin)
    k, nsy, nsx, _ = positions.shape
    if tuple(orig.shape) != (nsy * 4, nsx * 4):
        raise ValueError(f"sad_bilinear_positions: original "
                         f"{tuple(orig.shape)} for {nsy}x{nsx} subblocks")
    _check_sub("sad_bilinear_positions", ref_padded, positions)
    return _launch_search("sad_bilinear_positions", ref_padded, positions,
                          (k, nsy, nsx), (5, 5), margin, None, orig, None)
