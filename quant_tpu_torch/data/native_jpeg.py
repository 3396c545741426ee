"""ctypes bindings for the native JPEG decode pipeline (port of
quant_tpu/data/native_jpeg.py).

Builds `native/quantjpeg.cpp` (with libjpeg) into
`build/quant_tpu_torch/_quantjpeg.so` at first use (`_native_build`).
`AVAILABLE` (computed when first read) says whether the native path is
active; the ImageNet loader decodes with PIL otherwise. The decode
geometry (crop box, flip) is decided by the caller in Python, so the
native and PIL paths draw the same augmentation from one rng stream;
only the decoder and resampler differ.
"""

import ctypes
import logging
from typing import Optional

import numpy as np

from quant_tpu_torch.data._native_build import NativeLibrary

logger = logging.getLogger(__name__)


def _declare(lib: ctypes.CDLL) -> None:
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.qj_probe.argtypes = [u8p, i64, i32p, i32p]
    lib.qj_probe.restype = i32
    lib.qj_decode.argtypes = [u8p, i64, i32, i32, i32, i32, i32, i32,
                              i32, u8p]
    lib.qj_decode.restype = i32
    f32 = ctypes.c_float
    u8a = np.ctypeslib.ndpointer(np.uint8, flags='C_CONTIGUOUS')
    i32a = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
    f32a = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
    lib.qj_jitter_norm.argtypes = [u8a, i64, f32, f32, f32, i32a, i32,
                                   f32a, f32a, f32a]
    lib.qj_jitter_norm.restype = i32


_LIB = NativeLibrary('quantjpeg.cpp', '_quantjpeg.so', ('-ljpeg',),
                     _declare)


def _load() -> Optional[ctypes.CDLL]:
    return _LIB.get()


def __getattr__(name: str) -> bool:
    if name == 'AVAILABLE':
        return _load() is not None
    raise AttributeError(name)


def _as_u8p(data: bytes) -> object:
    return ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8))


def probe(data: bytes) -> Optional[tuple[int, int]]:
    """JPEG (width, height) from the header, or None on parse failure."""
    lib = _load()
    if lib is None:
        return None
    w, h = ctypes.c_int32(), ctypes.c_int32()
    if lib.qj_probe(_as_u8p(data), len(data),
                    ctypes.byref(w), ctypes.byref(h)):
        return None
    return int(w.value), int(h.value)


def decode_crop_resize(data: bytes, box: Optional[tuple[int, int, int, int]],
                       out_size: tuple[int, int],
                       flip: bool = False) -> Optional[np.ndarray]:
    """Decode `box` (x0, y0, w, h; None = full image) to uint8 RGB
    (out_h, out_w, 3), optionally mirrored. None on decode failure."""
    lib = _load()
    if lib is None:
        return None
    x0, y0, cw, ch = box if box is not None else (0, 0, 0, 0)
    out_w, out_h = out_size
    out = np.empty((out_h, out_w, 3), np.uint8)
    rc = lib.qj_decode(_as_u8p(data), len(data), x0, y0, cw, ch,
                       out_w, out_h, int(flip),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return None if rc else out


def jitter_norm(img: np.ndarray, mean: np.ndarray, std: np.ndarray,
                factors: Optional[tuple[float, float, float]] = None,
                order: Optional[np.ndarray] = None) -> Optional[np.ndarray]:
    """Fused ColorJitter (apply_color_jitter semantics) + normalization
    on a uint8 HWC image -> float32. factors=None skips the jitter
    (eval path). None when the native lib is absent."""
    lib = _load()
    if lib is None:
        return None
    h, w, c = img.shape
    assert c == 3
    fb, fc, fs = factors if factors is not None else (1.0, 1.0, 1.0)
    order_arr = (np.ascontiguousarray(order, np.int32)
                 if order is not None else np.empty((0,), np.int32))
    out = np.empty((h, w, 3), np.float32)
    rc = lib.qj_jitter_norm(np.ascontiguousarray(img), h * w,
                            fb, fc, fs, order_arr, len(order_arr),
                            np.ascontiguousarray(mean, np.float32),
                            np.ascontiguousarray(std, np.float32), out)
    return None if rc else out
