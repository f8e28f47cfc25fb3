"""Device <-> host transfer helpers of the encoder.

PyTorch counterpart of `vvc_mm_tpu/utils/xfer.py`.  Every device-to-host
copy makes the host wait for the device, so a stage's results are packed
into ONE flat buffer on the device and pulled in a single copy, and the
PSNR's squared errors are reduced on the device so that only scalars cross.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def _pull_packed(arrs, dtype: torch.dtype) -> list[np.ndarray]:
    flat = torch.cat([a.to(dtype).reshape(-1) for a in arrs]).cpu().numpy()
    out = []
    off = 0
    for a in arrs:
        n = a.numel()
        out.append(flat[off:off + n].reshape(tuple(a.shape))
                   .astype(np.int32))
        off += n
    return out


def pull_levels(*arrs) -> list[np.ndarray]:
    """Pull any number of int level grids in ONE int16 copy (quantized
    transform levels always fit int16); re-widened to int32 on the host
    for the entropy coder."""
    return _pull_packed(arrs, torch.int16)


def pull_i32(*arrs) -> list[np.ndarray]:
    """Pull arrays that may exceed the int16 range (e.g. per-block SADs)
    in ONE int32 copy."""
    return _pull_packed(arrs, torch.int32)


def finalize_recon(recon: dict, dev_orig, bit_depth: int
                   ) -> tuple[list[np.ndarray], tuple[float, float, float]]:
    """Pull the reconstruction (one narrow packed copy) and its PSNRs
    (device-side SSE, scalar pull).  Returns ([y, u, v] int32 np arrays,
    (psnr_y, psnr_u, psnr_v))."""
    planes = (recon["y"], recon["u"], recon["v"])
    dt = torch.uint8 if bit_depth <= 8 else torch.int16
    sse = torch.stack([((a - b).to(torch.int64) ** 2).sum()
                       for a, b in zip(planes, dev_orig)]).cpu().numpy()
    out = _pull_packed(planes, dt)     # samples are below 2^14
    maxv = (1 << bit_depth) - 1
    psnrs = tuple(
        999.99 if s == 0 else
        float(10.0 * np.log10(maxv * maxv * a.numel() / float(s)))
        for s, a in zip(sse, planes))
    return out, psnrs


def upload_planes(planes, bit_depth: int, device=None):
    """Host planes -> int32 tensors on `device` (CUDA unless another is
    named), copied as the narrowest dtype and widened there."""
    device = resolve_device(device)
    dt = np.uint8 if bit_depth <= 8 else np.int16
    return tuple(torch.from_numpy(np.ascontiguousarray(p, dtype=dt))
                 .to(device).to(torch.int32) for p in planes)


def pull_nested(obj):
    """pull_levels over every tensor of a nest of lists, tuples and dicts,
    in ONE int16 copy: returns the same nest with numpy int32 arrays in
    place of the tensors."""
    leaves = []

    def collect(o):
        if torch.is_tensor(o):
            leaves.append(o)
        elif isinstance(o, dict):
            for v in o.values():
                collect(v)
        elif isinstance(o, (list, tuple)):
            for v in o:
                collect(v)
    collect(obj)
    pulled = iter(pull_levels(*leaves))

    def rebuild(o):
        if torch.is_tensor(o):
            return next(pulled)
        if isinstance(o, dict):
            return {k: rebuild(v) for k, v in o.items()}
        if isinstance(o, (list, tuple)):
            return type(o)(rebuild(v) for v in o)
        return o
    return rebuild(obj)
