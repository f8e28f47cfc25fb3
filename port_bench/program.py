"""The system under test: `vvc_mm_tpu_torch`'s encoder and decoder, and the
benchmark-side wrappers that take spans and launch records from it.

The only module of the benchmark that imports the port.  Untraced runs
call `EncLib(cfg, device).encode_sequence(frames)` and
`DecLib(device).decode_bytes(data)` as they are.  A traced run
(`Instruments`) wraps, from here, the picture calls of EncLib and DecLib
(a span and a synchronise each), turns the port's stage timers on
(`utils/profiling.py`: each stage synchronises, so the traced run is
serialised) with a span a stage, and records each launch of the
hand-written kernels (K1-K6, D1, D2 and L1's sphere and elementwise
entries) with the arguments that `counts.py` needs.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from vvc_mm_tpu_torch.common import wavefront
from vvc_mm_tpu_torch.common.mm import mc as mm_mc
from vvc_mm_tpu_torch.common.slice_ps import MMConfig
from vvc_mm_tpu_torch.decoder.declib import DecLib
from vvc_mm_tpu_torch.encoder.enclib import EncCfg, EncLib
from vvc_mm_tpu_torch.ops import (cuda_lib, depquant_kernel, libm_kernel,
                                  mc_kernel, sphere_kernel)
from vvc_mm_tpu_torch.utils import native, profiling

from . import counts

_FIELDS = {f.name for f in dataclasses.fields(EncCfg)}


def enc_cfg(config: dict, **override) -> EncCfg:
    """The EncCfg of a configuration file: its keys that are EncCfg
    fields, `mm` as MMConfig's fields."""
    kw = {k: v for k, v in {**config, **override}.items() if k in _FIELDS}
    if "mm" in kw:
        kw["mm"] = MMConfig(**kw["mm"])
    for key in ("scaling_list", "mcts_tiles"):
        if key in kw:
            kw[key] = tuple(kw[key])
    if "epipoles" in kw:
        kw["epipoles"] = [tuple(e) for e in kw["epipoles"]]
    return EncCfg(**kw)


def build(device: torch.device) -> None:
    """Build (or find built) the native CABAC coder and, on a GPU, every
    CUDA source of the port: into `vvc_mm_tpu_torch/_build/` inside the
    checkout, where later runs find them."""
    native.get_lib()
    if device.type == "cuda":
        cuda_lib.build_all()


def plant(kind: str):
    """Plant a fault of faults.PROGRAM_KINDS in the program; returns the
    function that takes it out again.  `search`: the multi-model search's
    SADs (K3, K5, K6) and the intra mode decision's SATDs come back with
    their candidate axis turned by half its length, so each candidate is
    costed as another."""
    if kind != "search":
        raise ValueError(f"no program fault {kind!r}")
    saved = [(mm_mc, name, getattr(mm_mc, name)) for name in (
        "sad_block_positions", "sad_positions_multi",
        "sad_bilinear_positions")] + [(wavefront, "satd", wavefront.satd)]

    def turned(fn, dim):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if out.dim() <= dim:
                return out
            return torch.roll(out, max(1, out.shape[dim] // 2), dim)
        return call
    for owner, name, fn in saved:
        setattr(owner, name, turned(fn, 1 if owner is wavefront else 0))

    def undo() -> None:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    return undo


@dataclasses.dataclass
class Encoded:
    data: bytes
    recon: dict[int, list[np.ndarray]]     # POC -> (y, u, v)


class Encoder:
    """One unit: a new EncLib codes a clip whole."""

    def __init__(self, config: dict, device: torch.device,
                 instruments: "Instruments | None" = None, **override):
        self.cfg = enc_cfg(config, **override)
        self.device = device
        self.instruments = instruments

    def run(self, frames: list) -> Encoded:
        cls = EncLib if self.instruments is None else self.instruments.enclib
        enc = cls(self.cfg, device=self.device)
        data = enc.encode_sequence(frames)
        return Encoded(data, {r.poc: r.recon for r in enc.results})


class Decoder:
    """One unit: a new DecLib decodes a stream whole, and its pictures
    leave the device, as a player's do."""

    def __init__(self, device: torch.device,
                 instruments: "Instruments | None" = None):
        self.device = device
        self.instruments = instruments

    def run(self, data: bytes) -> dict[int, list[np.ndarray]]:
        cls = DecLib if self.instruments is None else self.instruments.declib
        dec = cls(device=self.device)
        return {f.poc: f.numpy() for f in dec.decode_bytes(data)}


class Instruments:
    """The traced run's wrappers, on between `start()` and `stop()`.

    `pictures`: (kind, seconds) of each picture call, synchronised;
    `spans`: a devtrace.Spans of units, pictures and stages; `launches`:
    (kernel, least seconds or None, tensors) of each launch, K1/K2's
    least time counted after the window (`least_by_kernel`)."""

    def __init__(self, spans, device: torch.device) -> None:
        self.spans = spans
        self.device = device
        self.pictures: list[tuple[str, float]] = []
        self.launches: list[tuple[str, float | None, tuple]] = []
        self._saved: list[tuple[object, str, object]] = []
        self.enclib = self._picture_class(EncLib, {
            "encode_intra_frame": "I", "encode_p_frame": "P",
            "encode_b_frame": "B"})
        self.declib = self._picture_class(DecLib, {
            "_decode_i": "I", "_decode_p_mm": "P", "_decode_b_mm": "B"})

    def _picture_class(self, base, kinds: dict):
        inst = self

        def wrap(method_name: str, kind: str):
            method = getattr(base, method_name)

            def call(self, *args, **kw):
                inst.spans.begin(kind)
                t0 = time.perf_counter()
                try:
                    return method(self, *args, **kw)
                finally:
                    if inst.device.type == "cuda":
                        torch.cuda.synchronize(inst.device)
                    inst.pictures.append((kind, time.perf_counter() - t0))
                    inst.spans.end()
            return call
        return type("Measured" + base.__name__, (base,),
                    {m: wrap(m, k) for m, k in kinds.items()})

    def _patch(self, owner, name: str, new) -> None:
        self._saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, new)

    def start(self) -> None:
        inst = self
        enter, exit_ = profiling.stage.__enter__, profiling.stage.__exit__

        def stage_enter(st):
            inst.spans.begin(st.name)
            return enter(st)

        def stage_exit(st, *exc):
            try:
                return exit_(st, *exc)
            finally:
                inst.spans.end()
        self._patch(profiling.stage, "__enter__", stage_enter)
        self._patch(profiling.stage, "__exit__", stage_exit)
        profiling.reset()
        profiling.enable(True)

        mc_launch, search_launch = mc_kernel._launch, mc_kernel._launch_search
        dq_launch = depquant_kernel._launch

        def k12(name, s, ref_padded, positions, margin, bit_depth):
            out = mc_launch(name, s, ref_padded, positions, margin, bit_depth)
            if out.numel():
                inst.launches.append((name, None, (ref_padded, positions,
                                                   margin, s)))
            return out

        def k36(name, ref_padded, positions, out_shape, win, margin,
                bit_depth, orig, s):
            out = search_launch(name, ref_padded, positions, out_shape, win,
                                margin, bit_depth, orig, s)
            if out.numel():
                inst.launches.append((name, counts.search_least_s(
                    name, ref_padded.numel(), tuple(positions.shape),
                    0 if orig is None else orig.numel(), s), ()))
            return out

        def dq(name, device, *args):
            dq_launch(name, device, *args)
            inst.launches.append((name, counts.dq_least_s(
                name, int(args[1]), int(args[2])), ()))
        libm_launch, sphere_launch = libm_kernel._launch, sphere_kernel.launch

        def libm(name, out, *args):
            libm_launch(name, out, *args)
            inst.launches.append((name, counts.libm_least_s(
                name, out.numel()), ()))

        def sphere(name, tmpl, model_idx, mvs, out, row_step=1,
                   col_step=1):
            sphere_launch(name, tmpl, model_idx, mvs, out, row_step,
                          col_step)
            k, _, nby, nbx = mvs.shape[:4]
            inst.launches.append((name, counts.sphere_least_s(
                name, list(tmpl.code)[:tmpl.n_models],
                counts.SPHERE_FORMS[tmpl.form], model_idx, k, nby, nbx,
                tmpl.bs, row_step, col_step), ()))
        self._patch(mc_kernel, "_launch", k12)
        self._patch(mc_kernel, "_launch_search", k36)
        self._patch(depquant_kernel, "_launch", dq)
        self._patch(libm_kernel, "_launch", libm)
        self._patch(sphere_kernel, "launch", sphere)

    def stop(self) -> dict[str, float]:
        """Undo the wrappers; the stage seconds of the traced window."""
        profiling.enable(False)
        stages = profiling.totals()
        profiling.reset()
        while self._saved:
            owner, name, old = self._saved.pop()
            setattr(owner, name, old)
        return stages

    def least_by_kernel(self) -> dict[str, tuple[int, float]]:
        """Kernel -> (launches, summed least seconds)."""
        out: dict[str, tuple[int, float]] = {}
        for name, least, tensors in self.launches:
            if least is None:
                ref, positions, margin, s = tensors
                least = counts.mc_least_s(ref, positions, margin, s)
            n, total = out.get(name, (0, 0.0))
            out[name] = (n + 1, total + least)
        self.launches.clear()
        return out
