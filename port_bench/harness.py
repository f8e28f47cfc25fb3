"""One run of one cell: set-up, the measured window and, with tracing,
the per-layer record; then the check of what the window produced.

A traffic mix (`traffic/<name>.json`) is read by one general generator,
`make_units`:
- `mode`: "encode" (a unit's clip in, `encode_sequence`) or "decode" (a
  unit's stream in, `decode_bytes`; set-up encodes the streams with the
  port's encoder);
- `unit`: "sequence" (a whole clip of `frames` pictures a unit) or
  "picture" (one picture a unit, a stream of its own, taking the clip's
  `frames` pictures in turn, picture i turned by i / `frames` of a
  circle);
- `variants`: how many clips, each the seeded clip turned about the
  vertical axis by another share of a circle (`clip.yaw`), the units
  take in turn, so that no unit codes what the unit before it coded;
- `loop`: "closed": the next unit starts when the last has ended;
- `check_units`: how many of the window's units, drawn from the seed,
  the reference decodes (encode; a decode run compares every unit);
- `warmup`: a short run of the same path before the window (`width`,
  `height`, `frames`); a decode at the cell's own size decodes the first
  `frames` pictures of its first stream.
The window closes at the first unit boundary at or after `seconds`.
"""
from __future__ import annotations

import time

import torch

from . import check, clip, counts, devtrace, faults


class Units:
    """What the units of a run take in turn: `frames[i]` the source
    pictures of input i, `streams[i]` its stream (decode)."""

    def __init__(self, frames: list, streams: list | None = None) -> None:
        self.frames = frames
        self.streams = streams

    def __len__(self) -> int:
        return len(self.frames)


def make_units(config: dict, traffic: dict, seed: int) -> Units:
    """The inputs of a run: clips made from the seed, in the traffic's
    units (streams are added by `run_cell`'s set-up)."""
    w, h = config["width"], config["height"]
    base = clip.realistic_sequence(w, h, traffic["frames"],
                                   clip.seed_words(seed))
    if traffic["unit"] == "picture":
        n = len(base)
        return Units([clip.yaw([f], i / n) for i, f in enumerate(base)])
    n = traffic.get("variants", 1)
    return Units([base if v == 0 else clip.yaw(base, v / n)
                  for v in range(n)])


def first_pictures(data: bytes, n: int) -> bytes:
    """A stream's parameter sets and its first `n` pictures in decoding
    order, with their SEIs."""
    from .refcodec.common.bitstream import (NAL_IDR, NAL_TRAIL, read_annexb,
                                            write_annexb)
    out, pictures = [], 0
    for nal in read_annexb(data):
        if nal.nal_type in (NAL_IDR, NAL_TRAIL):
            if pictures == n:
                break
            pictures += 1
        out.append(nal)
    return write_annexb(out)


def _warm_up(program, config: dict, traffic: dict, units: Units, seed: int,
             device: torch.device) -> None:
    """The traffic's `warmup`: at the cell's own size a decode takes the
    first pictures of the first stream; otherwise a clip of that size is
    encoded (and decoded)."""
    wu = traffic.get("warmup")
    if not wu:
        return
    own = (wu["width"], wu["height"]) == (config["width"], config["height"])
    if traffic["mode"] == "decode" and own:
        program.Decoder(device).run(first_pictures(units.streams[0],
                                                   wu["frames"]))
        return
    small = clip.realistic_sequence(wu["width"], wu["height"], wu["frames"],
                                    clip.seed_words(seed) + [2])
    enc = program.Encoder(config, device, width=wu["width"],
                          height=wu["height"])
    if traffic["unit"] == "picture":
        for f in small:
            out = enc.run([f])
    else:
        out = enc.run(small)
    if traffic["mode"] == "decode":
        program.Decoder(device).run(out.data)


def run_cell(config: dict, traffic: dict, seed: int, seconds: float,
             trace: bool, device: torch.device, t_start: float,
             fault: str | None = None, max_units: int | None = None
             ) -> dict:
    """Set-up and window.  Returns the run's figures: `setup_s`,
    `window_s`, `pictures`, `units`, `memory_peak_bytes`, with `trace`
    the per-layer `record` and `breakdown`, and what `judge` checks:
    `mode`, each unit's `outputs`, `frames_of_unit` and
    `streams_of_unit`.  `fault` plants one of faults.KINDS or
    faults.PROGRAM_KINDS in the timed path; `max_units` closes the window
    after that many units (tests)."""
    from . import program
    program.build(device)
    units = make_units(config, traffic, seed)
    mode = traffic["mode"]
    if mode == "decode":
        enc = program.Encoder(config, device)
        units.streams = [enc.run(f).data for f in units.frames]
    _warm_up(program, config, traffic, units, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    inst = spans = prof = traced = None
    if trace:
        spans = devtrace.Spans()
        inst = program.Instruments(spans, device)

    def make_runner(instruments):
        return (program.Encoder(config, device, instruments)
                if mode == "encode" else program.Decoder(device, instruments))
    runner = make_runner(inst)
    plant = faults.Fault(fault) if fault in faults.KINDS else None
    undo = program.plant(fault) if fault in faults.PROGRAM_KINDS else None
    outputs, taken, unit_s = [], [], []
    if trace:
        prof = devtrace.profiler()
        prof.start()
        for _ in range(3):          # the profiler misses its first records
            devtrace.mark()
        inst.start()
        host_mark = devtrace.mark()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    while True:
        i = len(outputs) % len(units)
        if inst is not None:
            spans.begin("unit")
        job = units.frames[i] if mode == "encode" else units.streams[i]
        out = runner.run(job)
        if inst is not None:
            spans.end()
        outputs.append(plant(out) if plant is not None else out)
        taken.append(i)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        unit_s.append(t1 - t0 - sum(unit_s))
        if inst is not None:
            # the first unit is the traced one: stop, and go on untraced
            end_mark = devtrace.mark()
            stages = inst.stop()
            prof.stop()
            traced = (inst, stages, host_mark, t0, t1, end_mark,
                      len(units.frames[i]))
            inst = None
            runner = make_runner(None)
        if t1 - t0 >= seconds or len(outputs) == max_units:
            break
    window_s = t1 - t0
    if undo is not None:
        undo()
    pictures = sum(len(units.frames[i]) for i in taken)
    result = dict(setup_s=setup_s, window_s=window_s, pictures=pictures,
                  units=len(outputs), unit_s=unit_s)
    if traced is not None:
        result.update(_traced(prof, spans, mode, *traced))
    result["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                   if device.type == "cuda" else 0)
    del runner
    if device.type == "cuda":
        torch.cuda.empty_cache()
    result.update(mode=mode, outputs=outputs,
                  frames_of_unit=[units.frames[i] for i in taken],
                  streams_of_unit=([units.streams[i] for i in taken]
                                   if mode == "decode" else None))
    return result


def judge(result: dict, traffic: dict, seed: int, limits: dict,
          fault: str | None = None, ref_cache: dict | None = None,
          workers: int = 1, expect: dict | None = None) -> check.Judgement:
    """The check of a run's outputs (`run_cell`'s result); with `fault`,
    of the outputs with that fault planted afterwards (`control.py`).
    The reference decodes up to `workers` streams at once; `expect` is the
    cell's expected first unit (`spec.load_expect`), and `limits` holds
    its limits too."""
    outputs = result["outputs"]
    if fault is not None:
        plant = faults.Fault(fault)
        outputs = [plant(o) for o in outputs]
    if result["mode"] == "encode":
        return check.judge_encode(result["frames_of_unit"], outputs, seed,
                                  limits, traffic.get("check_units", 1),
                                  ref_cache, workers, expect)
    return check.judge_decode(result["frames_of_unit"],
                              result["streams_of_unit"], outputs, limits,
                              ref_cache, workers)


def _traced(prof, spans, mode: str, inst, stages, host_mark: int, t0: float,
            t1: float, end_mark: int, pictures: int) -> dict:
    """The traced unit's per-layer record and breakdown (the window's
    first unit: tracing all of a window's million-odd device operations
    would take minutes to read).  The device clock is tied to the host's
    by the marker kernel launched at `host_mark` (perf_counter_ns) right
    before the window."""
    events = devtrace.device_events(prof)
    marks = [e for e in events if devtrace.MARKER in e[0]]
    ops = [e for e in events if devtrace.MARKER not in e[0]]
    if len(marks) < 2:
        raise RuntimeError(f"the profiler caught {len(marks)} marker "
                           "kernels of the 5 launched")
    offset = marks[-2][1] - host_mark          # device ns - host ns
    lo = int(t0 * 1e9) + offset
    hi = int(t1 * 1e9) + offset
    inside = [e for e in ops if e[2] > lo and e[1] < hi]
    intervals = [(s, e) for _, s, e in inside]
    busy = devtrace.busy_ns(intervals, lo, hi) * 1e-9
    gaps = devtrace.idle_gaps(intervals, lo, hi)
    least = inst.least_by_kernel()
    kernels = {}
    for name, (n, least_s) in least.items():
        fam = counts.FAMILY_OF[name]
        pat = devtrace.family_pattern(fam)
        dev = [e[2] - e[1] for e in inside if pat.search(e[0])]
        k = kernels.setdefault(fam, dict(launches=0, least_s=0.0,
                                         events=len(dev),
                                         device_s=sum(dev) * 1e-9))
        k["launches"] += n
        k["least_s"] += least_s
    window_s = (hi - lo) * 1e-9
    record = dict(mode=mode, pictures=pictures, window_s=window_s,
                  busy_s=busy, device_ops=len(inside),
                  picture_seconds=list(inst.pictures), stages=stages,
                  kernels=kernels,
                  clock_drift_ns=(marks[-1][1] - end_mark) - offset)
    return dict(record=record, busy_s=busy, traced_window_s=window_s,
                breakdown=devtrace.breakdown(inside, gaps, offset, spans))
