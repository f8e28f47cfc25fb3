"""Shared arithmetic of the per-layer metric readers in `metrics/`.

A reader gets the traced window's record (`harness._traced`): `mode`
("encode" or "decode"), `pictures` coded in the window, `window_s` and
`busy_s` (device clock), `device_ops` (device operations in the window),
`picture_seconds` ((kind, seconds) of each picture call, synchronised),
`stages` (the port's stage timers, seconds by stage) and `kernels`
(launch counts, least seconds and device seconds by kernel family).  A
reader that finds nothing to read returns None.
"""
from __future__ import annotations


def mean_picture_s(rec: dict, mode: str, kind: str) -> float | None:
    if rec["mode"] != mode:
        return None
    xs = [s for k, s in rec["picture_seconds"] if k == kind]
    return sum(xs) / len(xs) if xs else None


def stage_pct(rec: dict, match) -> float | None:
    """Percent of the staged seconds in the stages `match(name)` picks."""
    stages = rec["stages"] if rec["mode"] == "encode" else {}
    total = sum(stages.values())
    if total <= 0:
        return None
    return 100.0 * sum(v for k, v in stages.items() if match(k)) / total


def ops_per_frame(rec: dict, mode: str) -> float | None:
    if rec["mode"] != mode or not rec["pictures"] or not rec["device_ops"]:
        return None
    return rec["device_ops"] / rec["pictures"]


def idle_pct(rec: dict, mode: str) -> float | None:
    if rec["mode"] != mode or rec["window_s"] <= 0 or rec["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])


def roofline_pct(rec: dict, mode: str) -> float | None:
    """Summed least time over summed device time of the hand-written
    kernels traced in the window.  Where the profiler caught fewer (or
    more) of a family's launches than were made, its least time is
    scaled to the launches it caught."""
    if rec["mode"] != mode:
        return None
    least = device = 0.0
    for k in rec["kernels"].values():
        if k["events"] and k["launches"] and k["device_s"] > 0:
            least += k["least_s"] * k["events"] / k["launches"]
            device += k["device_s"]
    return 100.0 * least / device if device > 0 else None
