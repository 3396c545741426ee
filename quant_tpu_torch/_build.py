"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Each `csrc/<name>.cu` compiles on its own into
`build/quant_tpu_torch/<name>-<hash>/lib<name>.so`, keyed by a hash of
the sources and flags, with a plain C interface: every entry takes raw
device pointers and the CUDA stream as `void*`, launches on that stream,
allocates nothing and returns `cudaGetLastError()`. The wrappers raise on
a non-zero status. Missing nvcc raises; nothing falls back.

Also here: the launch counters every kernel wrapper bumps, so a run can
show that its path went through the kernels.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterable, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_ROOT = Path(__file__).resolve().parent.parent / 'build' / 'quant_tpu_torch'
SOURCES = ('xnor', 'pool', 'probe', 'solve')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_declared: dict[str, set[str]] = {}


class LaunchCounter:
    """Counts one kernel's launches (bumped by its wrapper only)."""

    def __init__(self, name: str):
        self.name = name
        self._n = 0
        self._lock = threading.Lock()
        COUNTERS[name] = self

    def bump(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


COUNTERS: dict[str, LaunchCounter] = {}


def reset_launch_counts() -> None:
    for c in COUNTERS.values():
        c.reset()


def launch_counts() -> dict[str, int]:
    return {name: c.count for name, c in COUNTERS.items()}


def nvcc_path() -> str:
    """The CUDA toolkit's nvcc; raises when there is none."""
    from torch.utils.cpp_extension import CUDA_HOME
    candidates = []
    if CUDA_HOME:
        candidates.append(str(Path(CUDA_HOME) / 'bin' / 'nvcc'))
    found = shutil.which('nvcc')
    if found:
        candidates.append(found)
    for c in candidates:
        if os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        'nvcc not found: the quant_tpu_torch CUDA kernels are built with '
        'the CUDA toolkit on the machine with the GPU.')


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob('*.cu*')):
        if f.suffix == '.cuh' or f.stem == name:
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_ROOT / f'{name}-{h.hexdigest()[:16]}' / f'lib{name}.so'


def build(names: Iterable[str] = SOURCES,
          verbose: bool = False) -> dict[str, str]:
    """Compile every named source not yet built, all nvcc runs at once.

    Returns {name: compiler output} for the sources compiled by this
    call (with verbose=True the output includes ptxas' register and
    shared-memory report). Raises RuntimeError if any compile fails.
    """
    todo = [n for n in names if not _lib_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = []
    for name in todo:
        out = _lib_path(name)
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
        cmd = [nvcc, *NVCC_FLAGS, *(['-Xptxas=-v'] if verbose else []),
               '-o', str(tmp), str(CSRC / f'{name}.cu')]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = {}, []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f'{name}.cu (exit {proc.returncode}):\n{log}')
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return logs


def load(name: str, signatures: dict[str, Sequence]) -> ctypes.CDLL:
    """Build (if needed) and load lib<name>.so, declaring `signatures`
    ({symbol: argtypes}); every symbol returns an int CUDA status."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.qtt_error_string.argtypes = [ctypes.c_int]
            lib.qtt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
            _declared[name] = set()
        # Several wrapper modules load one library, each with its own
        # symbols: declare every symbol on its first load.
        for sym in signatures.keys() - _declared[name]:
            fn = getattr(lib, sym)
            fn.argtypes = list(signatures[sym])
            fn.restype = ctypes.c_int
            _declared[name].add(sym)
        return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raise if a launch returned a non-zero CUDA status."""
    if status != 0:
        msg = lib.qtt_error_string(status).decode()
        raise RuntimeError(f'{what}: CUDA error {status} ({msg})')


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True if every tensor lies on the CPU, False if every one is on
    CUDA; raises on a mix or any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {'cpu'}:
        return True
    if kinds == {'cuda'} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f'tensors must all be on one CPU or CUDA device, '
                     f'got {sorted(str(t.device) for t in tensors)}')


def require(cond: bool, what: str) -> None:
    if not cond:
        raise ValueError(what)
