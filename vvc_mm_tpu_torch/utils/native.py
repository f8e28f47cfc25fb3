"""Build + ctypes binding for the native CABAC coder.

The C implementation (the repository's native/cabac.c, shared with the JAX
package and not edited here) is the port's arithmetic encoder and decoder;
the Python BinEncoder/BinDecoder in common/cabac.py are its executable
specification, and the tests hold them bit-identical.  Built at first use with the system
compiler into vvc_mm_tpu_torch/_build/ (reused while newer than the
source); a failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from . import profiling

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_PKG), "native", "cabac.c")
_BUILD = os.path.join(_PKG, "_build")
_SO = os.path.join(_BUILD, "libvvccabac.so")

_lib = None


class _ResCtx(ctypes.Structure):
    _fields_ = [("lastx_off", ctypes.c_int), ("lasty_off", ctypes.c_int),
                ("sigcg_off", ctypes.c_int), ("sig_off", ctypes.c_int),
                ("gtx_off", ctypes.c_int)]


def _build() -> str:
    os.makedirs(_BUILD, exist_ok=True)
    if (os.path.exists(_SO)
            and os.path.getmtime(_SO) >= os.path.getmtime(_SRC)):
        return _SO
    cc = os.environ.get("CC", "cc")
    # build beside the target and rename: concurrent test workers may race
    tmp = f"{_SO}.{os.getpid()}"
    cmd = [cc, "-O2", "-fPIC", "-shared", "-o", tmp, _SRC]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {_SRC} failed:\n{proc.stderr}")
    os.replace(tmp, _SO)
    return _SO


def get_lib() -> ctypes.CDLL:
    """The loaded native library, built if needed (a `native_lib` span
    while tracing)."""
    if _lib is not None:
        return _lib
    with profiling.span("native_lib"):
        return _load()


def _load() -> ctypes.CDLL:
    global _lib
    lib = ctypes.CDLL(_build())
    lib.enc_new.restype = ctypes.c_void_p
    lib.enc_new.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.enc_free.argtypes = [ctypes.c_void_p]
    lib.enc_bin.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.enc_bin_ep.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.enc_bins_ep.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                ctypes.c_int]
    lib.enc_eg.argtypes = [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_int]
    lib.enc_finish.restype = ctypes.c_int64
    lib.enc_finish.argtypes = [ctypes.c_void_p]
    lib.enc_copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.enc_coeffs.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_int, ctypes.POINTER(_ResCtx)]
    lib.dec_new.restype = ctypes.c_void_p
    lib.dec_new.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                            ctypes.c_void_p, ctypes.c_int]
    lib.dec_free.argtypes = [ctypes.c_void_p]
    lib.dec_bin.restype = ctypes.c_int
    lib.dec_bin.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dec_bin_ep.restype = ctypes.c_int
    lib.dec_bin_ep.argtypes = [ctypes.c_void_p]
    lib.dec_bins_ep.restype = ctypes.c_uint32
    lib.dec_bins_ep.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dec_eg.restype = ctypes.c_uint32
    lib.dec_eg.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.dec_coeffs.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                               ctypes.c_int, ctypes.POINTER(_ResCtx)]
    _lib = lib
    return _lib


def _res_ctx() -> _ResCtx:
    from ..common.contexts import CTX_OFFSET
    return _ResCtx(CTX_OFFSET["LastX"], CTX_OFFSET["LastY"],
                   CTX_OFFSET["SigCoeffGroup"], CTX_OFFSET["SigFlag"],
                   CTX_OFFSET["GtxFlag"])


class NativeBinEncoder:
    """The C counterpart of common.cabac.BinEncoder, plus residual coding
    (encode_coeffs, the counterpart of residual_coding.encode_coeffs)."""

    def __init__(self) -> None:
        from ..common.contexts import _INIT_P1, NUM_CTX
        self._lib = get_lib()
        init = np.ascontiguousarray(_INIT_P1, dtype=np.int32)
        self._h = self._lib.enc_new(init.ctypes.data, NUM_CTX)
        self._rc = _res_ctx()

    def encode_bin(self, binval: int, ctx: int) -> None:
        self._lib.enc_bin(self._h, int(binval), ctx)

    def encode_bin_ep(self, binval: int) -> None:
        self._lib.enc_bin_ep(self._h, int(binval))

    def encode_bins_ep(self, value: int, nbits: int) -> None:
        self._lib.enc_bins_ep(self._h, int(value), nbits)

    def encode_eg(self, value: int, k: int) -> None:
        self._lib.enc_eg(self._h, int(value), k)

    def encode_coeffs(self, levels: np.ndarray, chroma: bool) -> None:
        from ..common import rom
        h, w = levels.shape
        scan = rom.scan_order(w.bit_length() - 1, h.bit_length() - 1)
        lv = np.ascontiguousarray(levels, dtype=np.int32)
        sc = np.ascontiguousarray(scan, dtype=np.int32)
        self._lib.enc_coeffs(self._h, lv.ctypes.data, h, w, sc.ctypes.data,
                             int(chroma), ctypes.byref(self._rc))

    def finish(self) -> bytes:
        n = self._lib.enc_finish(self._h)
        buf = ctypes.create_string_buffer(n)
        self._lib.enc_copy(self._h, buf)
        return buf.raw

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.enc_free(self._h)
            self._h = None


class NativeBinDecoder:
    """The C counterpart of common.cabac.BinDecoder, plus residual decoding
    (decode_coeffs, the counterpart of residual_coding.decode_coeffs)."""

    def __init__(self, data: bytes) -> None:
        from ..common.contexts import _INIT_P1, NUM_CTX
        self._lib = get_lib()
        self._data = data        # keep alive: C borrows the pointer
        init = np.ascontiguousarray(_INIT_P1, dtype=np.int32)
        self._h = self._lib.dec_new(data, len(data), init.ctypes.data,
                                    NUM_CTX)
        self._rc = _res_ctx()

    def decode_bin(self, ctx: int) -> int:
        return self._lib.dec_bin(self._h, ctx)

    def decode_bin_ep(self) -> int:
        return self._lib.dec_bin_ep(self._h)

    def decode_bins_ep(self, nbits: int) -> int:
        return self._lib.dec_bins_ep(self._h, nbits)

    def decode_eg(self, k: int) -> int:
        return self._lib.dec_eg(self._h, k)

    def decode_coeffs(self, h: int, w: int, chroma: bool) -> np.ndarray:
        from ..common import rom
        scan = rom.scan_order(w.bit_length() - 1, h.bit_length() - 1)
        out = np.zeros(h * w, dtype=np.int32)
        sc = np.ascontiguousarray(scan, dtype=np.int32)
        self._lib.dec_coeffs(self._h, out.ctypes.data, h, w, sc.ctypes.data,
                             int(chroma), ctypes.byref(self._rc))
        return out.reshape(h, w)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.dec_free(self._h)
            self._h = None

