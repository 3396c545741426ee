"""Build and load the native data-pipeline libraries (port of
quant_tpu/data/_native_build.py).

The port builds the unedited sources `native/quantdata.cpp` and
`native/quantjpeg.cpp` with g++ itself, into `build/quant_tpu_torch/`
(never into the JAX package). A compile goes to a temporary file that is
os.replace()d into place, so concurrent processes never load a
half-written library. A library that cannot be built or loaded is
remembered as missing for the life of the process, and its callers take
their numpy or PIL paths.
"""

import ctypes
import logging
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

logger = logging.getLogger(__name__)

REPO = Path(__file__).resolve().parents[2]
NATIVE_SRC = REPO / 'native'
BUILD_DIR = REPO / 'build' / 'quant_tpu_torch'


def build_and_load(src: Path, so: Path,
                   extra_flags: Sequence[str] = ()) -> Optional[ctypes.CDLL]:
    """Load `so`, building it from `src` first when missing.

    Returns None (with a log note) when the source is absent, the
    compiler is unavailable, the flags don't apply on this host, or the
    load fails.
    """
    if not so.exists():
        if not src.exists():
            return None
        so.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=str(so.parent))
        os.close(fd)
        try:
            subprocess.run(
                ['g++', '-O3', '-march=native', '-fPIC', '-shared',
                 str(src), '-o', tmp, *extra_flags],
                check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)  # atomic: never a half-written .so
        except (OSError, subprocess.SubprocessError) as e:
            logger.info('native build of %s skipped: %s', so.name, e)
            return None
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    try:
        return ctypes.CDLL(str(so))
    except OSError as e:  # pragma: no cover
        logger.info('native load of %s failed: %s', so.name, e)
        return None


class NativeLibrary:
    """One library, built and loaded at its first use (not at import);
    `get()` returns the CDLL with its signatures declared, or None."""

    def __init__(self, src: str, so: str, flags: Sequence[str],
                 declare: object):
        self.src, self.so = NATIVE_SRC / src, BUILD_DIR / so
        self.flags, self.declare = tuple(flags), declare
        self._tried, self._lib = False, None

    def get(self) -> Optional[ctypes.CDLL]:
        if not self._tried:
            self._tried = True
            lib = build_and_load(self.src, self.so, self.flags)
            if lib is not None:
                self.declare(lib)
            self._lib = lib
        return self._lib
