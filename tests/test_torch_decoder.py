"""PyTorch port, the decoder as a whole: the committed 256x128 ERP
multi-model RA stream (I, P on the MM quadtree, MM B) decoded by the JAX
DecLib and by the port's DecLib(device="cpu").

* The I picture is bit-exact and its MD5 SEI matches.
* Each P/B picture, decoded from the JAX decoder's reference pictures
  (dpb_from_numpy) with the JAX decoder's positions injected, is
  bit-exact: everything downstream of the positions is integer math.
* Decoded on its own, with its own float32 positions, the port measures
  0 differing samples (PSNR gap 0 dB) on this stream, and that measured
  figure is the tolerance."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vvc_mm_tpu.common.mm import frame_codec as jax_fc
from vvc_mm_tpu.decoder.declib import DecLib as JaxDecLib
from vvc_mm_tpu_torch.common.bitstream import (BitReader, NAL_IDR, NAL_SPS,
                                               NAL_TRAIL, read_annexb)
from vvc_mm_tpu_torch.common.deblock import boundary_strengths_intra
from vvc_mm_tpu_torch.common.mm.frame_codec import predict_from_positions
from vvc_mm_tpu_torch.common.mm.reprojection import MVReprojection
from vvc_mm_tpu_torch.common.slice_ps import SPS, SliceHeader
from vvc_mm_tpu_torch.convert import dpb_from_numpy
from vvc_mm_tpu_torch.decoder.declib import DecLib
from vvc_mm_tpu_torch.lib360.projection import ERP
from vvc_mm_tpu_torch.utils.content import psnr, realistic_sequence

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")
STREAM = os.path.join(DATA, "erp256x128_ra_mm_qp37_5f.bin")
MAX_DIFF_SHARE = 0.0       # measured: no sample differs on this stream
MAX_PSNR_GAP_DB = 0.0


@pytest.fixture(scope="module")
def stream():
    return open(STREAM, "rb").read()


@pytest.fixture(scope="module")
def jax_dec(stream):
    dec = JaxDecLib()
    dec.decode_bytes(stream)
    return dec


def test_port_decodes_stream_like_jax(stream, jax_dec):
    dec = DecLib(device="cpu")
    frames = dec.decode_bytes(stream)
    assert [f.poc for f in frames] == [f.poc for f in jax_dec.frames]
    assert dec.hash_status[0] == "OK"
    src = realistic_sequence(256, 128, 5)
    n_diff = n_all = 0
    for f, g in zip(frames, jax_dec.frames):
        for p, q in zip(f.numpy(), g.planes):
            assert p.shape == q.shape and p.dtype == np.int32
            n_diff += int((p != q).sum())
            n_all += p.size
        gap = abs(psnr(src[f.poc][0], f.numpy()[0])
                  - psnr(src[f.poc][0], g.planes[0]))
        assert gap <= MAX_PSNR_GAP_DB, (f.poc, gap)
        if f.poc == 0:
            for p, q in zip(f.numpy(), g.planes):
                np.testing.assert_array_equal(p, q)
    assert n_diff / n_all <= MAX_DIFF_SHARE
    assert dec.hash_status == jax_dec.hash_status


def test_each_inter_picture_bit_exact_from_jax_state(stream, jax_dec):
    """One slice at a time, against the exact references and positions
    the JAX decoder used."""
    def jax_positions(active, midx, stack, block_size, epipoles, row_step):
        assert row_step == 1            # no projected DMVR in this stream
        return np.asarray(jax_fc.merged_positions(
            jax_dec.reproj, active, jnp.asarray(midx), jnp.asarray(stack),
            block_size, epipoles))

    dec = DecLib(device="cpu", positions_fn=jax_positions)
    want = {f.poc: f.planes for f in jax_dec.frames}
    seen = []
    for nalu in read_annexb(stream):
        if nalu.nal_type == NAL_SPS:
            dec._activate_sps(SPS.read(BitReader(nalu.payload)))
        elif nalu.nal_type in (NAL_IDR, NAL_TRAIL):
            poc = SliceHeader.read(BitReader(nalu.payload), dec.sps).poc
            if poc == 0:
                continue
            dec.frames = dpb_from_numpy(
                [f for f in jax_dec.frames if f.poc != poc], device="cpu")
            dec.decode_slice(nalu.payload)
            got = [f for f in dec.frames if f.poc == poc][0].numpy()
            for p, q in zip(got, want[poc]):
                np.testing.assert_array_equal(p, q)
            seen.append(poc)
    assert sorted(seen) == [1, 2, 3, 4]


def test_dpb_from_numpy_round_trip(jax_dec):
    dpb = dpb_from_numpy([(f.poc, f.planes) for f in jax_dec.frames],
                         device="cpu")
    for a, b in zip(dpb, jax_dec.frames):
        assert a.poc == b.poc and a.md5() == b.md5()
        assert all(p.dtype == torch.int32 for p in a.planes)


def test_declib_needs_explicit_cpu_without_gpu():
    """Every entry point that places state on a device defaults to CUDA
    and raises without one, instead of working on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        DecLib()
    with pytest.raises(RuntimeError):
        dpb_from_numpy([(0, [np.zeros((8, 8), np.int32)] * 3)])
    with pytest.raises(RuntimeError):
        MVReprojection(ERP(64, 32), 64, 32)
    with pytest.raises(RuntimeError):
        boundary_strengths_intra(4, 8)


def test_references_off_the_decoders_device_raise(stream, jax_dec):
    """A DPB on another device than the decoder's is refused, not moved:
    the MC would otherwise quietly leave the decoder's device."""
    dec = DecLib(device="meta")
    for nalu in read_annexb(stream):
        if nalu.nal_type == NAL_SPS:
            dec._activate_sps(SPS.read(BitReader(nalu.payload)))
        elif nalu.nal_type == NAL_TRAIL:
            dec.frames = dpb_from_numpy(jax_dec.frames, device="cpu")
            with pytest.raises(ValueError, match="reference POC"):
                dec.decode_slice(nalu.payload)
            return
    pytest.fail("the stream holds no inter slice")


def test_positions_off_the_references_device_raise():
    ref = torch.zeros((32, 64), dtype=torch.int32)
    pos = torch.zeros((8, 16, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="positions"):
        predict_from_positions(pos, ref, ref[:16, :32], ref[:16, :32], 8)
