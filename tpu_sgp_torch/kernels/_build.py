"""Build the port's CUDA sources with nvcc, load them with ctypes, and
bind, check, launch and count their C entries.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``build/tpu_sgp_torch/`` at the root of the checkout (listed
in ``.gitignore``), under a name that carries the hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt. The compiler's report
(``-Xptxas -v``: registers, shared memory, spills) is kept beside the
library as ``<library>.log``.

Every C entry returns 0 or a CUDA error code. ``entry`` binds one once,
``check_operands`` checks a launch's tensors, ``launch`` calls a kernel
entry on the device's current stream and counts it in ``launches``, and
``query`` calls a plan entry for its out-parameters.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'tpu_sgp_torch'

# sm_90a: Hopper with its architecture-specific instructions. -fmad=false
# keeps every multiply and add rounded on its own, as the plain PyTorch
# version rounds them, so kernel and plain version differ only in the
# order of their sums.
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '-std=c++17', '-shared', '-Xcompiler', '-fPIC', '-fmad=false',
              '-Xptxas', '-v')

_LOADED: dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()   # serving threads may race to the first use
_CACHES = []    # the caches of ``cached``, which ``use_library`` clears
# successful kernel launches by key ('project_rows', 'solve_rows/TcPatch', ...)
launches: collections.Counter = collections.Counter()
FLOATS = (torch.float32, torch.float64)


def nvcc() -> str:
    """Path of nvcc, from the CUDA installation PyTorch itself finds."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError('no CUDA toolkit found (set CUDA_HOME or put '
                           'nvcc on PATH): the port builds its kernels '
                           'with nvcc')
    path = Path(CUDA_HOME) / 'bin' / 'nvcc'
    if not path.exists():
        raise RuntimeError(f'nvcc not found under CUDA_HOME={CUDA_HOME}')
    return str(path)


def library_path(name: str) -> Path:
    """The library's path, named by the hash of its source, the shared
    headers under ``csrc/`` and the flags."""
    key = (_CSRC / f'{name}.cu').read_bytes()
    for header in sorted(_CSRC.glob('*.cuh')):
        key += header.name.encode() + header.read_bytes()
    key += ' '.join(NVCC_FLAGS).encode()
    return BUILD_DIR / f'lib{name}-{hashlib.sha256(key).hexdigest()[:16]}.so'


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source hash
    exists; returns the library's path. Raises if nvcc fails."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = [nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(_CSRC / f'{name}.cu')]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed on {name}.cu ({" ".join(cmd)}):\n'
                           f'{proc.stdout}{proc.stderr}')
    out.with_name(out.name + '.log').write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LOADED.get(name)
            if lib is None:
                lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
    return lib


def use_library(name: str, path) -> None:
    """Load ``path`` as the library of ``csrc/<name>.cu`` in place of the
    one built from the source (an edited copy, to time it), and forget
    every entry and plan bound so far."""
    with _LOAD_LOCK:
        _LOADED[name] = ctypes.CDLL(str(path))
    for cache in _CACHES:
        cache.cache_clear()


def cached(fn):
    """``functools.cache`` for what a loaded library answers (its bound
    entries, its plans), cleared by ``use_library``."""
    fn = functools.cache(fn)
    _CACHES.append(fn)
    return fn


@cached
def entry(library: str, symbol: str, argtypes: tuple):
    """The C function ``symbol`` of ``csrc/<library>.cu``, bound once to
    ``argtypes`` and an int result."""
    fn = getattr(load_library(library), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


@cached
def kernel(library: str, symbol: str, dtype: torch.dtype, argtypes: tuple):
    """The kernel entry ``<symbol>_f32`` or ``<symbol>_f64`` of ``dtype``,
    bound to ``argtypes`` and then the device index and stream that
    ``launch`` appends."""
    return entry(library, f'{symbol}_f{torch.finfo(dtype).bits}',
                 argtypes + (ctypes.c_int, ctypes.c_void_p))


def launch(fn, device: torch.device, *args, what: str, count=()) -> None:
    """Call the kernel entry ``fn`` with ``args`` and then ``device``'s
    index and current stream, the stream every kernel of the port runs on.
    Raises ``RuntimeError`` on a nonzero return; after a zero return adds
    1 to ``launches`` under each key of the tuple ``count``."""
    err = fn(*args, device.index,
             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f'{what}: CUDA error {err}')
    for key in count:
        launches[key] += 1


def query(library: str, symbol: str, *args: int, outs: tuple,
          what: str) -> tuple:
    """Call the plan entry ``symbol`` with the C ints ``args`` and then one
    out-parameter of each ctypes type in ``outs``; returns their values.
    Raises ``RuntimeError`` on a nonzero return."""
    fn = entry(library, symbol, (ctypes.c_int,) * len(args)
               + tuple(map(ctypes.POINTER, outs)))
    vals = [t() for t in outs]
    err = fn(*args, *map(ctypes.byref, vals))
    if err != 0:
        raise RuntimeError(f'{what}: CUDA error {err}')
    return tuple(v.value for v in vals)


def check_operands(ref: str, /, *, sizes: tuple = (),
                   unit_stride: bool = False, **named) -> dict:
    """Check a launch's tensors before it; returns ``{axis letter: size}``.
    Each of ``named`` is ``name=(tensor, axes)``, ``axes`` a letter an axis
    (``'BN'``; None: any shape): the first tensor to use a letter sets its
    size, the others must match (``ValueError``). A CUDA ``ref`` is also
    held to what a launch needs: float32 or float64, every tensor in its
    dtype on its device (``TypeError``), contiguous or with ``unit_stride``
    of unit stride along its rows, and each ``(name, value or letter,
    least)`` of ``sizes`` in [least, 2**31), a C int (``ValueError``)."""
    r = named[ref][0]
    cuda = r.is_cuda
    if cuda:
        dtype, device = r.dtype, r.device
        if dtype not in FLOATS:
            raise TypeError(f'the kernel takes float32 or float64, got '
                            f'{dtype}')
    dims = {}
    for name, (t, spec) in named.items():
        if spec is not None:
            shape = t.shape
            if (len(shape) != len(spec)
                    or tuple(map(dims.setdefault, spec, shape)) != shape):
                want = ', '.join(f'{d}={dims[d]}' if d in dims else d
                                 for d in spec)
                raise ValueError(f'{name} must have shape ({want}), got '
                                 f'{tuple(shape)}')
        if not cuda:
            continue
        if t is not r and (t.dtype != dtype or t.device != device):
            raise TypeError(f'{name} is {t.dtype} on {t.device}; {ref} is '
                            f'{dtype} on {device}')
        if unit_stride:
            if t.dim() and t.shape[-1] > 1 and t.stride(-1) != 1:
                raise ValueError(f'{name} must have unit stride along its '
                                 f'rows, got stride {t.stride(-1)}')
        elif not t.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if not cuda:
        return dims
    for name, value, least in sizes:
        if isinstance(value, str):
            value = dims[value]
        if not least <= value < 2 ** 31:
            raise ValueError(f'unsupported size: {name}={value}')
    return dims
