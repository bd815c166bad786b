"""Build the port's CUDA kernels with ``nvcc``, and its host library with
``g++``, and load them with ``ctypes``.

Each source under ``ever_tpu_torch/csrc/`` has a plain C interface and
compiles on its own into a shared library for ``sm_90a``, at first use, into
``ever_tpu_torch/_build/`` (listed in ``.gitignore``).  A library is keyed by
the hash of its source and of the shared headers (``csrc/*.cuh``), so an
edited source or header rebuilds.  ``build`` starts one ``nvcc`` per source,
all at once, and keeps the compiler's report (``-Xptxas -v``: registers,
spills, and ptxas's notes such as a serialized ``wgmma``) beside each
library; :func:`build_log` reads it.  The host library (``HOST_SOURCES``:
the data path's tile gather and PNG unfilter) is built by ``g++`` the same
way, keyed by its own source, when :func:`load` first asks for it; a failed
build raises, as a failed ``nvcc`` does.  Nothing is built at import time.

It also holds the port's ``torch.library`` namespace, ``ever_tpu_torch``
(:data:`LIB`; :func:`define_op` defines each kernel's op there), and the
device guard every op's wrapper calls (:func:`check_device`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Callable, Dict, Iterable, Optional

import torch

__all__ = ['SOURCES', 'HOST_SOURCES', 'build', 'build_host', 'build_log', 'load',
           'function', 'LIB', 'define_op', 'check_device']

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, 'csrc')
_BUILD = os.path.join(_PKG, '_build')

# kernel library name → source file under csrc/
SOURCES = {'attention_fwd': 'attention_fwd.cu',
           'attention_bwd': 'attention_bwd.cu',
           'maxpool_bwd': 'maxpool_bwd.cu',
           'layernorm': 'layernorm.cu',
           'quant_int8': 'quant_int8.cu',
           'int8_matmul': 'int8_matmul.cu'}

# host library name → C++ source under csrc/
HOST_SOURCES = {'tilekit': 'tilekit.cpp'}

_NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
               '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_GXX_FLAGS = ['-O3', '-std=c++17', '-shared', '-fPIC', '-pthread']

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which('nvcc'),
                 os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                              'bin', 'nvcc')):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA toolkit is needed to build '
                       'the port\'s kernels')


def _lib_path(name: str) -> str:
    digest = hashlib.sha1()
    if name in HOST_SOURCES:
        files = [HOST_SOURCES[name]]
    else:
        files = [SOURCES[name]] + sorted(f for f in os.listdir(_CSRC) if f.endswith('.cuh'))
    for fname in files:
        with open(os.path.join(_CSRC, fname), 'rb') as f:
            digest.update(f.read())
    return os.path.join(_BUILD, f'lib{name}-{digest.hexdigest()[:12]}.so')


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile the named kernel libraries (default: all), one ``nvcc`` per
    library, all started together.  Returns seconds per library (0.0 when
    it was already built); raises with nvcc's output on a failed build,
    after every started compiler has ended."""
    secs: Dict[str, float] = {}
    jobs = []
    for name in (SOURCES if names is None else names):
        out = _lib_path(name)
        secs[name] = 0.0
        if os.path.isfile(out):
            continue
        os.makedirs(_BUILD, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=_BUILD)
        os.close(fd)
        proc = subprocess.Popen([_nvcc(), *_NVCC_FLAGS, '-o', tmp,
                                 os.path.join(_CSRC, SOURCES[name])],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs.append((name, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, proc, t0 in jobs:
        log = proc.communicate()[0]
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f'nvcc failed for {SOURCES[name]}:\n{log}')
        else:
            with open(out[:-3] + '.log', 'w') as f:
                f.write(log)
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failed:
        raise RuntimeError('\n'.join(failed))
    return secs


def build_host(name: str) -> float:
    """Compile host library ``name`` with ``g++`` unless it is built;
    returns the seconds it took (0.0 when it was built already) and raises
    with the compiler's output on a failure."""
    out = _lib_path(name)
    if os.path.isfile(out):
        return 0.0
    gxx = shutil.which('g++')
    if gxx is None:
        raise RuntimeError('g++ not found: it builds the port\'s host library '
                           f'{HOST_SOURCES[name]}')
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=_BUILD)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([gxx, *_GXX_FLAGS, '-o', tmp,
                           os.path.join(_CSRC, HOST_SOURCES[name])],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'g++ failed for {HOST_SOURCES[name]}:\n{proc.stdout}')
    os.replace(tmp, out)
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's report from the build of kernel library ``name`` (built first
    if needed)."""
    build([name])
    with open(_lib_path(name)[:-3] + '.log') as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel or host library ``name``, built first if needed
    (once, whichever thread asks first)."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                if name in HOST_SOURCES:
                    build_host(name)
                else:
                    build([name])
                lib = ctypes.CDLL(_lib_path(name))
                _LIBS[name] = lib
    return lib


def function(lib: str, name: str, argtypes: Iterable):
    """The C entry point ``name`` of kernel library ``lib``, typed as the
    port's entry points all are: ``argtypes``, then the CUDA stream, and an
    ``int`` CUDA error code back.  Pointers belong in ``argtypes`` as
    ``c_void_p``, as the stream is: a plain int would be cut to 32 bits."""
    fn = getattr(load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


# The port's ``torch.library`` namespace.  Each kernel is an op defined here
# by :func:`define_op`; ops defined through a ``Library`` dispatch with less
# host work per call than ``torch.library.custom_op``'s.
LIB = torch.library.Library('ever_tpu_torch', 'DEF')


def define_op(schema: str, cpu: Callable, cuda: Callable, fake: Callable):
    """Define the op ``ever_tpu_torch::<schema>``: ``cpu`` runs on CPU
    tensors (a kernel's plain version), ``cuda`` on CUDA tensors (the
    kernel), ``fake`` gives the outputs' shapes and types for
    ``torch.export``.  Returns the op's default overload."""
    name = schema.split('(', 1)[0]
    LIB.define(schema)
    LIB.impl(name, cpu, 'CPU')
    LIB.impl(name, cuda, 'CUDA')
    torch.library.register_fake(f'ever_tpu_torch::{name}', fake, lib=LIB)
    return getattr(torch.ops.ever_tpu_torch, name).default


def check_device(t, kernel: str) -> None:
    """Raise unless ``t`` lies on the CPU (the plain version runs) or on a
    CUDA device (the kernel runs): no op of the port takes another device."""
    if t.device.type not in ('cpu', 'cuda'):
        raise RuntimeError(f'no {kernel} kernel for device {t.device}')
