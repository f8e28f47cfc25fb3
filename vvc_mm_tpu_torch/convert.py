"""Numpy <-> device conversion of the state the codec carries.

The codec has no weights; the state a decoder carries from picture to
picture is its DPB, and the state an encoder hands from stage to stage is
a handful of integer grids.  `dpb_from_numpy` turns pictures given as numpy
planes (for example the JAX package's `DecLib.frames`, or
`(poc, [y, u, v])` pairs) into the port's DPB on a device, so that one P or
B slice can be decoded against exactly the references another decoder used.
`planes_from_numpy` does the same for one source picture or reference, and
`search_from_numpy` for the outputs of a search (model index, MV stack, SAD
and candidate grids), so that stage N of the port can be fed stage N-1 of
another implementation.
"""
from __future__ import annotations

import numpy as np
import torch

from .decoder.declib import DecodedFrame
from .device import resolve_device


def dpb_from_numpy(frames, device=None) -> list[DecodedFrame]:
    """frames: iterable of objects with `.poc` and `.planes`, or of
    (poc, [y, u, v]) pairs -> list of DecodedFrame with int32 planes on
    `device` (CUDA unless another device is named)."""
    device = resolve_device(device)
    out = []
    for f in frames:
        poc, planes = (f.poc, f.planes) if hasattr(f, "planes") else f
        out.append(DecodedFrame(int(poc), [
            torch.from_numpy(np.array(p, dtype=np.int32)).to(device)
            for p in planes]))
    return out


def planes_from_numpy(planes, device=None) -> tuple[torch.Tensor, ...]:
    """[y, u, v] numpy planes (any integer dtype) -> int32 tensors on
    `device` (CUDA unless another device is named)."""
    device = resolve_device(device)
    return tuple(torch.from_numpy(np.array(p, dtype=np.int32)).to(device)
                 for p in planes)


def search_from_numpy(outputs, device=None):
    """The outputs of a search — a tuple (or list, nested as the search
    returned it) of integer or boolean numpy grids such as
    (idx, stack, sad, cand_idx, cand_mv, cand_sads) — as int32 (bool stays
    bool) tensors on `device` (CUDA unless another device is named)."""
    device = resolve_device(device)
    if isinstance(outputs, (tuple, list)):
        return type(outputs)(search_from_numpy(o, device) for o in outputs)
    a = np.asarray(outputs)
    dt = np.bool_ if a.dtype == np.bool_ else np.int32
    return torch.from_numpy(np.array(a, dtype=dt)).to(device)
