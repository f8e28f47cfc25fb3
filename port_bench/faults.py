"""Planted faults and the control: what `correct` has to catch.

Each of KINDS is applied to a unit's output where the program produced
it (in the window, through `harness.run_cell(fault=...)`), or to the
window's outputs afterwards (`control.py`); each of PROGRAM_KINDS is
planted in the program for the window (`program.plant`).  None is ever
planted in a run of `run.py`.

- `stale`: a step that returns its state unchanged: every unit after the
  first hands back the output of the unit before it;
- `half`: half of the batch left out: the second half of a unit's
  pictures is missing;
- `flip`: an answer altered where it is produced: one byte in the middle
  of an encoded stream, or one sample of a decoded picture;
- `search` (in the program): the encoder's search reads each
  candidate's cost from the wrong candidate: the candidate axis of the
  multi-model search's SADs (kernels K3, K5, K6) and of the intra mode
  decision's SATDs is turned by half its length.  The stream stays consistent with
  the reconstruction; only the bits and the distortion show it;
- `lsb`: the control.  The configuration states 8-bit samples decoded
  exactly (the decoded-picture-hash SEI); the control is the same output
  in the nearest precision below, 7 bits (the lowest bit cleared).

No cell runs on more than one chip, so no fault leaves out an exchange
between chips.
"""
from __future__ import annotations

import dataclasses

import numpy as np

KINDS = ("stale", "half", "flip", "lsb")
PROGRAM_KINDS = ("search",)


def _pictures(out):
    return out.recon if hasattr(out, "recon") else out


def _with_pictures(out, pics):
    if hasattr(out, "recon"):
        return dataclasses.replace(out, recon=pics)
    return pics


class Fault:
    def __init__(self, kind: str) -> None:
        if kind not in KINDS:
            raise ValueError(f"fault {kind!r} is not one of {KINDS}")
        self.kind = kind
        self._previous = None

    def __call__(self, out):
        kind = self.kind
        if kind == "stale":
            previous, self._previous = self._previous, out
            return out if previous is None else previous
        pics = _pictures(out)
        if kind == "half":
            keep = sorted(pics)[:len(pics) // 2]
            return _with_pictures(out, {p: pics[p] for p in keep})
        if kind == "lsb":
            return _with_pictures(out, {p: [np.asarray(c) & ~1 for c in v]
                                        for p, v in pics.items()})
        if hasattr(out, "data"):
            data = bytearray(out.data)
            data[len(data) // 2] ^= 0x10
            return dataclasses.replace(out, data=bytes(data))
        pics = dict(pics)
        poc = sorted(pics)[len(pics) // 2]
        y = np.array(pics[poc][0], copy=True)
        y[y.shape[0] // 2, y.shape[1] // 2] ^= 1
        pics[poc] = [y, *pics[poc][1:]]
        return pics
