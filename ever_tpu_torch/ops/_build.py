"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``ever_tpu_torch/csrc/`` has a plain C interface and
compiles on its own into a shared library for ``sm_90a``, at first use, into
``ever_tpu_torch/_build/`` (listed in ``.gitignore``).  A library is keyed by
the hash of its source and of the shared headers (``csrc/*.cuh``), so an
edited source or header rebuilds.  ``build`` starts one ``nvcc`` per source,
all at once, and keeps the compiler's report (``-Xptxas -v``: registers,
spills, and ptxas's notes such as a serialized ``wgmma``) beside each
library; :func:`build_log` reads it.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, Iterable, Optional

__all__ = ['SOURCES', 'build', 'build_log', 'load', 'function']

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

_NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
               '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_LIBS: Dict[str, ctypes.CDLL] = {}


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
    headers = sorted(f for f in os.listdir(_CSRC) if f.endswith('.cuh'))
    for fname in [SOURCES[name]] + headers:
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


def build_log(name: str) -> str:
    """nvcc's report from the build of kernel library ``name`` (built first
    if needed)."""
    build([name])
    with open(_lib_path(name)[:-3] + '.log') as f:
        return f.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
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
