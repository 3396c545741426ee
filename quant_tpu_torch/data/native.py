"""ctypes bindings for the native data-pipeline library (port of
quant_tpu/data/native.py).

Builds `native/quantdata.cpp` into `build/quant_tpu_torch/_quantdata.so`
at first use (`_native_build`). Every entry point has a numpy fallback,
taken when the library cannot be built; `AVAILABLE` (computed when
first read) says which path is active. The two shuffle backends give
different orders, so a batch equals the JAX package's only when both
take the same backend.
"""

import ctypes
import logging
from typing import Optional

import numpy as np

from quant_tpu_torch.data._native_build import NativeLibrary

logger = logging.getLogger(__name__)


def _declare(lib: ctypes.CDLL) -> None:
    i64, u64 = ctypes.c_int64, ctypes.c_uint64
    fp = np.ctypeslib.ndpointer(np.float32, flags='C_CONTIGUOUS')
    ip = np.ctypeslib.ndpointer(np.int32, flags='C_CONTIGUOUS')
    lib.qtd_shuffle.argtypes = [ip, i64, u64]
    lib.qtd_gather.argtypes = [fp, ip, fp, i64, i64]
    lib.qtd_crop_flip.argtypes = [fp, fp, i64, i64, i64, i64, i64, u64, fp]
    lib.qtd_make_batch.argtypes = [fp, ip, i64, fp, i64, i64, i64, i64,
                                   i64, u64, ctypes.c_int, fp]
    for name in ('qtd_shuffle', 'qtd_gather', 'qtd_crop_flip',
                 'qtd_make_batch'):
        getattr(lib, name).restype = None


_LIB = NativeLibrary('quantdata.cpp', '_quantdata.so', ('-fopenmp',),
                     _declare)


def _load() -> Optional[ctypes.CDLL]:
    return _LIB.get()


def __getattr__(name: str) -> bool:
    if name == 'AVAILABLE':
        return _load() is not None
    raise AttributeError(name)


def shuffled_order(n: int, seed: int) -> np.ndarray:
    idx = np.arange(n, dtype=np.int32)
    lib = _load()
    if lib is not None:
        lib.qtd_shuffle(idx, n, np.uint64(seed))
    else:
        np.random.default_rng(seed).shuffle(idx)
    return idx


def make_batch(src: np.ndarray, order: np.ndarray, start: int,
               batch: int, pad: int, seed: int, augment: bool,
               pad_value: Optional[np.ndarray] = None) -> np.ndarray:
    """Fused gather(+crop/flip) of one batch from an NHWC array.

    pad_value: per-channel fill for out-of-bounds crop pixels (the
    normalized value of a raw black pixel); zeros when omitted.
    """
    n, h, w, c = src.shape
    pv = np.zeros((c,), np.float32) if pad_value is None \
        else np.ascontiguousarray(pad_value, np.float32)
    lib = _load()
    out = np.empty((batch, h, w, c), np.float32)
    if lib is not None:
        lib.qtd_make_batch(np.ascontiguousarray(src, np.float32),
                           np.ascontiguousarray(order, np.int32),
                           start, out, batch, h, w, c, pad,
                           np.uint64(seed), int(augment), pv)
        return out
    sel = src[order[start:start + batch]]
    if not augment:
        return np.ascontiguousarray(sel, np.float32)
    from quant_tpu_torch.data.loaders import random_crop_flip
    return random_crop_flip(sel, np.random.default_rng(seed + start),
                            pad=pad, pad_value=pv).astype(np.float32)
