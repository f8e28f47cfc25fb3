"""PyTorch port, host layer: the copied jax-free modules parse the
committed stream's parameter sets, slice headers and CABAC bins exactly as
the JAX package does; the native CABAC binding agrees with the Python
specification; the encoder halves of cabac.py, residual_coding.py and
contexts.py write the JAX package's bytes and carry its rate tables; and
neither the port nor chip_smoke.py imports JAX or the
JAX package (checked on the sources with `ast`)."""
import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

from vvc_mm_tpu.common import bitstream as jax_bs
from vvc_mm_tpu.common import cabac as jax_cabac
from vvc_mm_tpu.common import contexts as jax_contexts
from vvc_mm_tpu.common import residual_coding as jax_rc
from vvc_mm_tpu.common import slice_ps as jax_ps
from vvc_mm_tpu.decoder import inter_parser as jax_inter
from vvc_mm_tpu.decoder import intra_parser as jax_intra
from vvc_mm_tpu_torch.common import bitstream, cabac, contexts
from vvc_mm_tpu_torch.common import residual_coding
from vvc_mm_tpu_torch.common import slice_ps
from vvc_mm_tpu_torch.common.typedefs import SliceType
from vvc_mm_tpu_torch.decoder import inter_parser, intra_parser
from vvc_mm_tpu_torch.utils import native

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STREAM = os.path.join(ROOT, "tests", "data", "torch_port",
                      "erp256x128_ra_mm_qp37_5f.bin")


def _norm(x):
    """Dataclass / tuple / array tree -> comparable plain Python."""
    if dataclasses.is_dataclass(x):
        return {k: _norm(v) for k, v in dataclasses.asdict(x).items()}
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    return x


def _slices(data):
    """(port sps, jax sps, [(payload, port header, jax header, offset)])"""
    out = []
    sps = jsps = None
    for a, b in zip(bitstream.read_annexb(data), jax_bs.read_annexb(data)):
        assert (a.nal_type, a.temporal_id, a.payload) == \
            (b.nal_type, b.temporal_id, b.payload)
        if a.nal_type == bitstream.NAL_SPS:
            sps = slice_ps.SPS.read(bitstream.BitReader(a.payload))
            jsps = jax_ps.SPS.read(jax_bs.BitReader(b.payload))
            assert _norm(sps) == _norm(jsps)
        elif a.nal_type == bitstream.NAL_PPS:
            assert _norm(slice_ps.PPS.read(bitstream.BitReader(a.payload))) \
                == _norm(jax_ps.PPS.read(jax_bs.BitReader(b.payload)))
        elif a.nal_type in (bitstream.NAL_IDR, bitstream.NAL_TRAIL):
            br = bitstream.BitReader(a.payload)
            sh = slice_ps.SliceHeader.read(br, sps)
            jbr = jax_bs.BitReader(b.payload)
            jsh = jax_ps.SliceHeader.read(jbr, jsps)
            assert br._pos == jbr._pos
            out.append((a.payload, sh, jsh, br._pos // 8))
    return sps, out


def test_headers_parse_like_jax():
    sps, slices = _slices(open(STREAM, "rb").read())
    assert sps.mm.any_enabled() and sps.inter_qt_depth == 1
    assert len(slices) == 5
    for _, sh, jsh, _ in slices:
        assert _norm(sh) == _norm(jsh)


def test_slice_bins_parse_like_jax():
    sps, slices = _slices(open(STREAM, "rb").read())
    active = sps.mm.active_models()
    kinds = set()
    for payload, sh, _, off in slices:
        data = bytes(payload[off:])
        if sh.slice_type == SliceType.I:
            s = sps.intra_block_size
            args = (data, sps.height // s, sps.width // s, s)
            got = intra_parser.decode_intra_slice(*args)
            want = jax_intra.decode_intra_slice(*args)
        elif sh.slice_type == SliceType.P:
            args = (data, sps.height, sps.width, sps.inter_block_size,
                    sps.inter_qt_depth, len(active))
            got = inter_parser.decode_p_slice_qt_mm(*args)
            want = jax_inter.decode_p_slice_qt_mm(*args)
        else:
            s = sps.inter_block_size
            mer = max(0, sps.log2_parallel_merge_level
                      - (s.bit_length() - 1))
            got = inter_parser.decode_b_slice_mm(
                data, sps.height // s, sps.width // s, s, active,
                use_merge=sps.merge, mer_blocks_log2=mer)
            want = jax_inter.decode_b_slice_mm(
                data, sps.height // s, sps.width // s, s, active,
                use_merge=sps.merge, mer_blocks_log2=mer)
        kinds.add(int(sh.slice_type))
        assert _norm(got) == _norm(want)
    assert len(kinds) == 3


@pytest.mark.parametrize("chroma", [False, True])
def test_residual_coding_spec_and_native_agree(rng, chroma):
    """Coefficients written by the JAX encoder read back identically by
    the port's Python spec decoder and its native (C) decoder."""
    blocks = [np.where(rng.random((8, 8)) < 0.3,
                       rng.integers(-40, 41, (8, 8)), 0).astype(np.int32)
              for _ in range(20)]
    enc = jax_cabac.BinEncoder()
    for b in blocks:
        jax_rc.encode_coeffs(enc, b, chroma)
    data = enc.finish()
    spec = cabac.BinDecoder(data)
    got = [residual_coding.decode_coeffs(spec, 8, 8, chroma) for _ in blocks]
    for g, b in zip(got, blocks):
        np.testing.assert_array_equal(g, b)
    fast = native.NativeBinDecoder(data)
    for b in blocks:
        np.testing.assert_array_equal(fast.decode_coeffs(8, 8, chroma), b)


def test_context_tables_and_rate_estimate_equal_jax(rng):
    """contexts.py: the context layout, the initial probabilities and the
    fractional-bit table; cabac.py: the sequential rate estimate."""
    assert contexts.NUM_CTX == jax_contexts.NUM_CTX
    assert contexts.CTX_OFFSET == jax_contexts.CTX_OFFSET
    np.testing.assert_array_equal(contexts._INIT_P1, jax_contexts._INIT_P1)
    assert contexts.FRAC_BITS_SCALE == jax_contexts.FRAC_BITS_SCALE
    np.testing.assert_array_equal(contexts.FRAC_BITS_TABLE,
                                  jax_contexts.FRAC_BITS_TABLE)
    p1 = rng.integers(0, contexts.PROB_ONE, 500)
    bins = rng.integers(0, 2, 500)
    np.testing.assert_array_equal(contexts.frac_bits(p1, bins),
                                  jax_contexts.frac_bits(p1, bins))
    ctxs = rng.integers(0, contexts.NUM_CTX, 500)
    state, jstate = contexts.ContextState(), jax_contexts.ContextState()
    got = cabac.estimate_bits_and_update(
        np.array(state.p0), np.array(state.p1), bins, ctxs)
    want = jax_cabac.estimate_bits_and_update(
        np.array(jstate.p0), np.array(jstate.p1), bins, ctxs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] > 0


def test_spec_encoder_writes_jax_bytes_and_reads_back(rng):
    """cabac.py BinEncoder, every public method (truncated unary included,
    which the native encoder does not carry): the JAX package's bytes, and
    the port's BinDecoder is its exact inverse."""
    ops = []
    for _ in range(1500):
        kind = int(rng.integers(0, 5))
        if kind == 0:
            ops.append(("bin", int(rng.integers(0, 2)),
                        int(rng.integers(0, contexts.NUM_CTX))))
        elif kind == 1:
            ops.append(("bin_ep", int(rng.integers(0, 2))))
        elif kind == 2:
            nb = int(rng.integers(1, 16))
            ops.append(("bins_ep", int(rng.integers(0, 1 << nb)), nb))
        elif kind == 3:
            mx = int(rng.integers(1, 8))
            ops.append(("unary", int(rng.integers(0, mx + 1)),
                        int(rng.integers(0, 20)), int(rng.integers(20, 40)),
                        mx))
        else:
            ops.append(("eg", int(rng.integers(0, 3000)),
                        int(rng.integers(0, 4))))
    enc, jenc = cabac.BinEncoder(), jax_cabac.BinEncoder()
    for op, *args in ops:
        getattr(enc, "encode_" + op)(*args)
        getattr(jenc, "encode_" + op)(*args)
    data = enc.finish()
    assert data == jenc.finish()
    assert enc.num_bins == jenc.num_bins
    dec = cabac.BinDecoder(data)
    for op, value, *args in ops:
        assert getattr(dec, "decode_" + op)(*args) == value


@pytest.mark.parametrize("shape", [(4, 4), (8, 8), (16, 16), (4, 8)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_residual_encoder_writes_jax_bytes(rng, shape):
    """residual_coding.py encode_coeffs, luma and chroma in one substream:
    the JAX package's bytes, read back by the port's spec decoder."""
    blocks = []
    for i in range(16):
        b = np.where(rng.random(shape) < 0.3,
                     rng.integers(-300, 301, shape), 0).astype(np.int32)
        b[tuple(rng.integers(0, n) for n in shape)] = 1 + i   # never empty
        blocks.append((b, bool(i & 1)))
    enc, jenc = cabac.BinEncoder(), jax_cabac.BinEncoder()
    for b, chroma in blocks:
        residual_coding.encode_coeffs(enc, b, chroma)
        jax_rc.encode_coeffs(jenc, b, chroma)
    data = enc.finish()
    assert data == jenc.finish()
    dec = cabac.BinDecoder(data)
    for b, chroma in blocks:
        np.testing.assert_array_equal(
            residual_coding.decode_coeffs(dec, *shape, chroma), b)
    for g in range(12):
        assert residual_coding._last_ctx(3, g, False) == \
            jax_rc._last_ctx(3, g, False)
        assert residual_coding._last_ctx(4, g, True) == \
            jax_rc._last_ctx(4, g, True)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_never_imports_jax():
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "compare_checkouts.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "vvc_mm_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "vvc_mm_tpu"), (f, mod)


def test_content_copy_matches_bench():
    """The port's numpy copy of bench.realistic_sequence, which the smoke
    run scores PSNR against, gives the same pictures."""
    import bench
    from vvc_mm_tpu_torch.utils.content import psnr, realistic_sequence
    from vvc_mm_tpu.common.picture import psnr as jax_psnr
    a = bench.realistic_sequence(64, 32, 3)
    b = realistic_sequence(64, 32, 3)
    for fa, fb in zip(a, b):
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x, y)
    assert psnr(a[0][0], a[1][0]) == jax_psnr(a[0][0], a[1][0])


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_yuv_writer_and_reader_match_jax(tmp_path, bit_depth):
    """A file the port's YuvWriter writes has the JAX YuvWriter's bytes
    (out-of-range samples clipped), and reads back equal through both
    readers, with skip_frames and the end of file."""
    from vvc_mm_tpu.utils import yuv_io as jax_yuv
    from vvc_mm_tpu_torch.utils import yuv_io
    rng = np.random.default_rng(31 + bit_depth)
    top = 1 << bit_depth
    fmt = yuv_io.VideoFormat(48, 32, bit_depth)
    jfmt = jax_yuv.VideoFormat(48, 32, bit_depth)
    assert fmt.chroma_size == jfmt.chroma_size == (16, 24)
    assert fmt.frame_bytes == jfmt.frame_bytes
    frames = [[rng.integers(-3, top + 3, (32, 48), dtype=np.int32),
               rng.integers(0, top, (16, 24), dtype=np.int32),
               rng.integers(0, top, (16, 24), dtype=np.int32)]
              for _ in range(3)]
    paths = [str(tmp_path / "port.yuv"), str(tmp_path / "jax.yuv")]
    with yuv_io.YuvWriter(paths[0], fmt) as wr:
        for f in frames:
            wr.write_frame(f)
    jwr = jax_yuv.YuvWriter(paths[1], jfmt)
    for f in frames:
        jwr.write_frame(f)
    jwr.close()
    data = open(paths[0], "rb").read()
    assert data == open(paths[1], "rb").read()
    assert len(data) == 3 * fmt.frame_bytes
    with yuv_io.YuvReader(paths[1], fmt) as rd:
        assert rd.num_frames == 3
        rd.skip_frames(1)
        got = [rd.read_frame(), rd.read_frame()]
        assert rd.read_frame() is None
    jrd = jax_yuv.YuvReader(paths[0], jfmt)
    jrd.skip_frames(1)
    want = [jrd.read_frame(), jrd.read_frame()]
    jrd.close()
    for f, g, src in zip(got, want, frames[1:]):
        for a, b, s in zip(f, g, src):
            assert a.dtype == np.int32
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, np.clip(s, 0, top - 1))


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_synthetic_sequence_matches_jax(bit_depth):
    from vvc_mm_tpu.utils import yuv_io as jax_yuv
    from vvc_mm_tpu_torch.common.typedefs import ChromaFormat
    from vvc_mm_tpu_torch.utils import yuv_io
    a = yuv_io.synthetic_sequence(yuv_io.VideoFormat(96, 64, bit_depth), 3)
    b = jax_yuv.synthetic_sequence(jax_yuv.VideoFormat(96, 64, bit_depth), 3)
    assert len(a) == len(b) == 3
    for fa, fb in zip(a, b):
        assert len(fa) == 3
        for x, y in zip(fa, fb):
            np.testing.assert_array_equal(x, y)
    mono = yuv_io.VideoFormat(32, 16, 8, ChromaFormat.C400)
    assert mono.frame_bytes == 32 * 16
    assert [len(f) for f in yuv_io.synthetic_sequence(mono, 2)] == [1, 1]
