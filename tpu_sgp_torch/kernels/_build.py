"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``build/tpu_sgp_torch/`` at the root of the checkout (listed
in ``.gitignore``), under a name that carries the hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or
header is rebuilt. The compiler's report
(``-Xptxas -v``: registers, shared memory, spills) is kept beside the
library as ``<library>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

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
        lib = _LOADED[name] = ctypes.CDLL(str(build(name)))
    return lib
