"""The ranks of tests/test_torch_sharding.py: every sharded encode of the
port's parallel/sharding.py in one gloo group of processes on the CPU.

Imported by the spawned ranks (it imports no JAX); pytest does not
collect it (its name does not start with `test_`)."""
from __future__ import annotations

import pickle

import numpy as np
import torch
import torch.distributed as dist

QP = 32


def frames(w: int, h: int, n: int, motion=(3.0, 1.0)):
    """synthetic_sequence pictures of the sharding cases."""
    from vvc_mm_tpu_torch.common.typedefs import ChromaFormat
    from vvc_mm_tpu_torch.utils.yuv_io import VideoFormat, synthetic_sequence
    return synthetic_sequence(VideoFormat(w, h, 8, ChromaFormat.C420), n,
                              motion=motion)


def mm_reprojection(w: int, h: int):
    """The multi-model case's MVReprojection (ERP, MPA+ROT) on the CPU and
    its active models."""
    from vvc_mm_tpu_torch.common.mm.reprojection import MVReprojection
    from vvc_mm_tpu_torch.common.slice_ps import MMConfig
    from vvc_mm_tpu_torch.lib360.projection import make_projection
    mm = MMConfig(mpa=True, rot=True)
    return (MVReprojection(make_projection(int(mm.projection), w, h), w, h,
                           mm.mm_offset_4x4, 1, device="cpu"),
            mm.active_models())


CASES = dict(
    intra=lambda: frames(64, 32, 2),
    p=lambda: frames(64, 128, 2),
    b=lambda: frames(64, 128, 3),
    mm=lambda: frames(128, 128, 2),
    halo=lambda: frames(64, 64, 2, (3.0, 2.0)),
)


def run_rank(rank: int, world: int, init: str, out: str) -> None:
    """One rank: every sharded encode; rank 0 pickles the results (each
    the whole frame's, as every rank returns them) to `out`."""
    from vvc_mm_tpu_torch.parallel import sharding
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        mesh = sharding.make_mesh()
        f = {k: make() for k, make in CASES.items()}
        reproj, active = mm_reprojection(128, 128)
        res = dict(
            mesh=(mesh.gop, mesh.tile, mesh.size),
            intra=sharding.encode_frames_sharded(f["intra"], QP, mesh,
                                                 device="cpu"),
            p=sharding.encode_p_frame_sharded(f["p"][1], f["p"][0], QP, mesh,
                                              search_range=8, device="cpu"),
            b=sharding.encode_b_frame_sharded(f["b"][1], f["b"][0],
                                              f["b"][2], QP, mesh,
                                              search_range=8, device="cpu"),
            mm=sharding.encode_p_frame_mm_sharded(
                reproj, active, f["mm"][1], f["mm"][0], QP, mesh,
                search_range=8, wrap_around=True),
            halo=sharding.encode_p_frame_sharded_ref(
                f["halo"][1], f["halo"][0], QP, mesh, search_range=8,
                wrap_around=True, device="cpu"))
        if rank == 0:
            with open(out, "wb") as fh:
                pickle.dump(res, fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def as_numpy(t) -> np.ndarray:
    return t.cpu().numpy() if torch.is_tensor(t) else np.asarray(t)
