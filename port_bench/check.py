"""Whether what the timed path produced is correct.

The judge is the plain reference decoder in `refcodec/`: a frozen copy of
the port's decoder, run on the CPU with its plain PyTorch and numpy paths
and the Python spec CABAC coder; it imports nothing of the program.  It
decodes the program's own streams (encode cells) or the streams the
program decoded (decode cells), after the window has closed.

Numbers compared, each with its limit (`limits`):
- `missing_pictures`: pictures due in the window that the program's
  output, or the reference's decode of its stream, lacks;
- `recon_mismatch` (encode): samples where the program's reconstruction
  differs from the reference's decode of the program's stream, over the
  units drawn from the seed;
- `output_mismatch` (decode): samples where the program's decoded
  pictures differ from the reference's decode of the same stream, over
  every unit;
- `md5_mismatch`: pictures whose decoded-picture-hash SEI does not match
  the reference's decode (or has none);
- `worst_mse_y`: the largest luma mean squared error of a picture the
  program produced against the source picture the benchmark made, over
  every unit: a stream that decodes as it says but codes another picture
  fails here;
- `bits_over_pct` (encode, where the cell has an `expect/<cell>.json`):
  by how many percent the window's first unit's stream is longer than
  that file expects of the same input (the median of sound runs over a
  dozen seeds or more).  An encoder that decides wrongly still writes a
  stream that decodes as it says; it pays in bits.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .clip import seed_words
from .refcodec.decoder.declib import DecLib as RefDecLib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_decode(data: bytes) -> tuple[dict, dict, str | None]:
    """(POC -> (y, u, v) int32 arrays, POC -> "OK"/"MISMATCH"/"MISSING",
    the error that stopped the decode or None)."""
    dec = RefDecLib(device="cpu")
    try:
        frames = dec.decode_bytes(data)
    except Exception as exc:          # a broken stream is a wrong answer
        return ({f.poc: f.numpy() for f in dec.frames}, dec.hash_status,
                f"{type(exc).__name__}: {exc}")
    return {f.poc: f.numpy() for f in frames}, dec.hash_status, None


def reference_decode_many(streams: list[bytes], cache: dict,
                          workers: int = 1, own_process: bool = False
                          ) -> None:
    """Decode each stream not yet in `cache` into it, `workers` at a time:
    each in a process of its own (`python -m port_bench.refworker`, the
    stream on its standard input, the pickled result on its output), the
    host's cores shared among them.  One worker decodes in this process,
    unless `own_process` (one thread, in a process of its own)."""
    todo = [d for d in dict.fromkeys(streams) if d not in cache]
    n = min(workers, len(todo))
    if n <= 1 and not own_process:
        for d in todo:
            cache[d] = reference_decode(d)
        return
    threads = str(1 if own_process else max(1, (os.cpu_count() or 1) // n))

    def one(data: bytes):
        out = subprocess.run([sys.executable, "-m", "port_bench.refworker",
                              threads], input=data, capture_output=True,
                             cwd=ROOT, check=True)
        return pickle.loads(out.stdout)
    with ThreadPoolExecutor(max(n, 1)) as ex:
        for d, out in zip(todo, ex.map(one, todo)):
            cache[d] = out


def sample_units(n_units: int, k: int, seed: int) -> list[int]:
    """`k` of the window's units, drawn from the seed."""
    rng = np.random.default_rng(seed_words(seed) + [1])
    return sorted(int(u) for u in rng.choice(n_units, size=min(k, n_units),
                                             replace=False))


def _mse(a: np.ndarray, b: np.ndarray) -> float:
    d = a.astype(np.int64) - b.astype(np.int64)
    return float((d * d).mean())


def _differ(a: list, b: list) -> int:
    return sum(int(np.count_nonzero(np.asarray(x) != np.asarray(y)))
               if np.shape(x) == np.shape(y) else int(np.size(y))
               for x, y in zip(a, b))


class Judgement:
    """The numbers compared, their limits, and the (unit, POC) pairs of
    the pictures found wrong."""

    def __init__(self, limits: dict) -> None:
        self.limits = limits
        self.numbers: dict[str, float] = {}
        self.bad: set[tuple[int, int]] = set()     # (unit, POC)
        self.errors: list[str] = []
        self.info: dict[str, float] = {}     # readings not compared

    def add(self, name: str, value: float) -> None:
        self.numbers[name] = self.numbers.get(name, 0) + value

    @property
    def correct(self) -> bool:
        return all(self.numbers[k] <= self.limits[k] for k in self.numbers)

    def lines(self) -> list[str]:
        return [f"error {e}" for e in self.errors] + [
            f"{k} {self.numbers[k]!r} limit {self.limits[k]!r}"
            for k in self.numbers]

    def as_dict(self) -> dict:
        return {k: {"value": self.numbers[k], "limit": self.limits[k]}
                for k in self.numbers}


def _source_mse(j: Judgement, u: int, pics: dict, frames: list) -> None:
    worst = j.numbers.get("worst_mse_y", 0.0)
    for poc, src in enumerate(frames):
        if poc in pics:
            mse = _mse(pics[poc][0], src[0])
            if mse > j.limits["worst_mse_y"]:
                j.bad.add((u, poc))
            worst = max(worst, mse)
    j.numbers["worst_mse_y"] = worst


def _missing(j: Judgement, u: int, have, n: int) -> None:
    gone = [p for p in range(n) if p not in have]
    j.add("missing_pictures", len(gone))
    j.bad.update((u, p) for p in gone)


def _first_unit(j: Judgement, n_pictures: int, out, expect: dict | None
                ) -> None:
    """The first unit's bits (`info`), and, with `expect`, their excess
    over it in percent."""
    bits = 8 * len(out.data)
    j.info["unit_bits"] = bits
    if expect is None:
        return
    j.numbers["bits_over_pct"] = 100.0 * (bits / expect["unit_bits"] - 1)
    if j.numbers["bits_over_pct"] > j.limits["bits_over_pct"]:
        j.bad.update((0, p) for p in range(n_pictures))


def judge_encode(frames_of_unit: list, outputs: list, seed: int,
                 limits: dict, check_units: int,
                 ref_cache: dict | None = None, workers: int = 1,
                 expect: dict | None = None) -> Judgement:
    """`frames_of_unit[u]`: the source clip of unit u; `outputs[u]`: the
    program's `Encoded` (stream and reconstruction); `expect`: the cell's
    expected first unit, or None."""
    j = Judgement(limits)
    for name in ("missing_pictures", "recon_mismatch", "md5_mismatch"):
        j.numbers[name] = 0
    j.numbers["worst_mse_y"] = 0.0
    for u, (frames, out) in enumerate(zip(frames_of_unit, outputs)):
        _missing(j, u, out.recon, len(frames))
        _source_mse(j, u, out.recon, frames)
    _first_unit(j, len(frames_of_unit[0]), outputs[0], expect)
    cache = {} if ref_cache is None else ref_cache
    sampled = sample_units(len(outputs), check_units, seed)
    reference_decode_many([outputs[u].data for u in sampled], cache, workers)
    for u in sampled:
        frames, out = frames_of_unit[u], outputs[u]
        ref, status, err = cache[out.data]
        if err:
            j.errors.append(f"unit {u}: {err}")
        for poc in range(len(frames)):
            if poc not in ref:
                j.add("missing_pictures", 1)
                j.bad.add((u, poc))
                continue
            if status.get(poc) != "OK":
                j.add("md5_mismatch", 1)
                j.bad.add((u, poc))
            if poc in out.recon:
                n = _differ(out.recon[poc], ref[poc])
                j.add("recon_mismatch", n)
                if n:
                    j.bad.add((u, poc))
    return j


def judge_decode(frames_of_unit: list, streams_of_unit: list, outputs: list,
                 limits: dict, ref_cache: dict | None = None,
                 workers: int = 1) -> Judgement:
    """`streams_of_unit[u]`: the stream unit u decoded; `outputs[u]`: the
    program's POC -> pictures.  Every unit is compared."""
    j = Judgement(limits)
    for name in ("missing_pictures", "output_mismatch", "md5_mismatch"):
        j.numbers[name] = 0
    j.numbers["worst_mse_y"] = 0.0
    cache = {} if ref_cache is None else ref_cache
    reference_decode_many(streams_of_unit, cache, workers)
    for data in dict.fromkeys(streams_of_unit):
        _, status, err = cache[data]
        if err:
            j.errors.append(err)
    counted = set()
    for u, (frames, data, pics) in enumerate(zip(frames_of_unit,
                                                 streams_of_unit, outputs)):
        ref, status, _ = cache[data]
        _missing(j, u, pics, len(frames))
        _source_mse(j, u, pics, frames)
        for poc in range(len(frames)):
            if data not in counted and status.get(poc) != "OK":
                j.add("md5_mismatch", 1)
                j.bad.add((u, poc))
            if poc in pics:
                n = (_differ(pics[poc], ref[poc]) if poc in ref
                     else sum(int(np.size(p)) for p in pics[poc]))
                j.add("output_mismatch", n)
                if n:
                    j.bad.add((u, poc))
        counted.add(data)
    return j


def use_threads() -> int:
    """The reference runs after the window, on every core of the host;
    the number of processes it may take (one a stream)."""
    cores = max(1, os.cpu_count() or 1)
    torch.set_num_threads(cores)
    return cores
