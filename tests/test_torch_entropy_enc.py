"""PyTorch port, host entropy encoding: the restored arithmetic encoder, the
native (C) encoder, residual coding and the two multi-model slice writers
give the JAX package's bytes on the same inputs.

The slice writers' inputs (split masks, leaf decisions, level grids, merge
flags) are the ones the port's encoder hands them for POC 4 (P) and POC 2
(B) of the 256x128 clip; the JAX package's writers are then called on
exactly those grids."""
import os

import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import cabac as jax_cabac
from vvc_mm_tpu.common import residual_coding as jax_rc
from vvc_mm_tpu.encoder import inter_coder as jax_ic
from vvc_mm_tpu.utils import native as jax_native
from vvc_mm_tpu_torch.common import cabac, residual_coding
from vvc_mm_tpu_torch.common.bitstream import NAL_SEI, read_annexb, \
    write_annexb
from vvc_mm_tpu_torch.common.slice_ps import MMConfig
from vvc_mm_tpu_torch.decoder.declib import DecLib
from vvc_mm_tpu_torch.encoder import enclib as port_enclib
from vvc_mm_tpu_torch.encoder import inter_coder
from vvc_mm_tpu_torch.utils import native
from vvc_mm_tpu_torch.utils.content import realistic_sequence

torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data", "torch_port")
STREAM = os.path.join(DATA, "erp256x128_ra_mm_qp37_5f.bin")


def _drive(enc, ops):
    for op, *args in ops:
        getattr(enc, op)(*args)
    return enc.finish()


def _random_ops(rng, n=4000):
    ops = []
    for _ in range(n):
        r = rng.random()
        if r < 0.6:
            ops.append(("encode_bin", int(rng.integers(0, 2)),
                        int(rng.integers(0, 60))))
        elif r < 0.8:
            ops.append(("encode_bin_ep", int(rng.integers(0, 2))))
        elif r < 0.9:
            nb = int(rng.integers(1, 12))
            ops.append(("encode_bins_ep", int(rng.integers(0, 1 << nb)), nb))
        else:
            ops.append(("encode_eg", int(rng.integers(0, 500)),
                        int(rng.integers(0, 4))))
    return ops


def test_bin_encoders_give_jax_bytes(rng):
    """Python spec == native C == the JAX package's spec, and the port's
    decoder reads the bins back."""
    ops = _random_ops(rng)
    want = _drive(jax_cabac.BinEncoder(), ops)
    assert _drive(cabac.BinEncoder(), ops) == want
    assert _drive(native.NativeBinEncoder(), ops) == want
    dec = cabac.BinDecoder(want)
    for op, *args in ops[:500]:
        if op == "encode_bin":
            assert dec.decode_bin(args[1]) == args[0]
        elif op == "encode_bin_ep":
            assert dec.decode_bin_ep() == args[0]
        elif op == "encode_bins_ep":
            assert dec.decode_bins_ep(args[1]) == args[0]
        else:
            assert dec.decode_eg(args[1]) == args[0]


@pytest.mark.parametrize("chroma", [False, True])
@pytest.mark.parametrize("size", [4, 8, 16])
def test_encode_coeffs_gives_jax_bytes(rng, size, chroma):
    blocks = [np.where(rng.random((size, size)) < 0.25,
                       rng.integers(-60, 61, (size, size)), 0)
              .astype(np.int32) for _ in range(24)]
    blocks = [b for b in blocks if b.any()]
    blocks.append(np.full((size, size), -32768, np.int32))
    jenc = jax_cabac.BinEncoder()
    spec = cabac.BinEncoder()
    fast = native.NativeBinEncoder()
    for b in blocks:
        jax_rc.encode_coeffs(jenc, b, chroma)
        residual_coding.encode_coeffs(spec, b, chroma)
        fast.encode_coeffs(b, chroma)
    want = jenc.finish()
    assert spec.finish() == want
    assert fast.finish() == want
    rd = native.NativeBinDecoder(want)
    for b in blocks:
        np.testing.assert_array_equal(rd.decode_coeffs(size, size, chroma),
                                      b)


def test_small_syntax_writers_give_jax_bytes(rng):
    """merge_idx, mvd, motion_model elements and the mvd bit estimate."""
    jenc, enc = jax_native.make_encoder(), native.NativeBinEncoder()
    for _ in range(300):
        idx = int(rng.integers(0, 6))
        v = int(rng.integers(-300, 301))
        m = int(rng.integers(0, 5))
        for e, mod in ((jenc, jax_ic), (enc, inter_coder)):
            mod.encode_merge_idx(e, idx)
            mod.encode_mvd_comp(e, v)
            mod.encode_motion_model(e, m, 5)
        assert inter_coder._mvd_bits(np.array([v, idx])) == \
            jax_ic._mvd_bits(np.array([v, idx]))
    assert enc.finish() == jenc.finish()
    assert inter_coder.QT_SPLIT_BIAS_BINS == jax_ic.QT_SPLIT_BIAS_BINS


@pytest.fixture(scope="module")
def writer_calls():
    """Run the port's encoder on POC 4 and POC 2 and record what it hands
    to the two slice writers, with the bytes they returned."""
    head = []
    for nal in read_annexb(open(STREAM, "rb").read()):
        head.append(nal)
        if nal.nal_type == NAL_SEI:
            break
    dec = DecLib(device="cpu")
    dec.decode_bytes(write_annexb(head))
    src = realistic_sequence(256, 128, 5)
    calls = {}

    def record(name):
        fn = getattr(inter_coder, name)

        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls[name] = (args, kwargs, out)
            return out
        return wrapper

    saved = {n: getattr(port_enclib, n)
             for n in ("encode_p_slice_qt_mm", "encode_b_slice_mm")}
    for n in saved:
        setattr(port_enclib, n, record(n))
    try:
        enc = port_enclib.EncLib(port_enclib.EncCfg(
            width=256, height=128, qp=37, gop="RA", qt_depth=1,
            wrap_around=True, mm=MMConfig(mpa=True, rot=True)),
            device="cpu")
        ref0 = dec.frames[0].numpy()
        _, r4 = enc.encode_p_frame(4, src[4], ref0, 0, qp=38)
        enc.encode_b_frame(2, src[2], ref0, 0, r4.recon, 4, 1, qp=38)
    finally:
        for n, fn in saved.items():
            setattr(port_enclib, n, fn)
    return calls


def test_p_slice_writer_gives_jax_bytes(writer_calls):
    args, kwargs, out = writer_calls["encode_p_slice_qt_mm"]
    assert jax_ic.encode_p_slice_qt_mm(*args, **kwargs) == out
    assert len(out) > 100


def test_b_slice_writer_gives_jax_bytes(writer_calls):
    args, kwargs, out = writer_calls["encode_b_slice_mm"]
    assert kwargs["merge_flag"] is not None
    assert jax_ic.encode_b_slice_mm(*args, **kwargs) == out
    assert len(out) > 100
    # the AMVP arm (no merge flags) on the same grids gives JAX's bytes too
    amvp = inter_coder.encode_b_slice_mm(*args, merge_flag=None,
                                         merge_idx=None)
    assert amvp == jax_ic.encode_b_slice_mm(*args, merge_flag=None,
                                            merge_idx=None)
    assert amvp != out
