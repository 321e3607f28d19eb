"""Build and load the package's hand-written CUDA kernels.

Each kernel source under ``montecarlo_tpu_torch/csrc/`` exposes plain C
entry points.  It is compiled with ``nvcc`` into a shared library at first
use, keyed by a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, into ``_build/`` beside the package (listed in ``.gitignore``),
and loaded with ``ctypes``.  Importing the package never needs ``nvcc``:
nothing here runs until a kernel is launched on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

__all__ = ["CudaKernel", "KERNELS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
            "toolkit is needed to build the package's kernels")
    return found

#: every :class:`CudaKernel` made in this process
KERNELS: list = []


class CudaKernel:
    """One C entry point of one ``.cu`` source: lazy build, launch, count.

    ``launches`` counts the launches made through :meth:`launch` and nothing
    else, so a run can show that it went through the kernel.  Entry points
    of one source share its library.  Every instance is listed in
    :data:`KERNELS`, where a run's counters read the launches it made.
    """

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = os.path.join(_CSRC, source)
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_seconds = None     # wall time of the nvcc call, if any
        self._fn = None
        KERNELS.append(self)

    def library_path(self) -> str:
        h = hashlib.sha256()
        for path in [self.source] + sorted(
                glob.glob(os.path.join(_CSRC, "*.cuh"))):
            with open(path, "rb") as f:
                h.update(f.read())
        h.update("\0".join(NVCC_FLAGS).encode())
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(_BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")

    def build(self):
        """Compile (if no library for this source exists yet) and load."""
        if self._fn is not None:
            return self._fn
        out = self.library_path()
        if not os.path.exists(out):
            os.makedirs(_BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, self.source],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {self.source}:\n{proc.stderr}")
                os.replace(tmp, out)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
            self.build_seconds = time.perf_counter() - t0
        fn = getattr(ctypes.CDLL(out), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def launch(self, *args):
        """Launch on the caller's stream; raise on a refused launch."""
        err = self.build()(*args)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol} launch failed: cudaError {err}")
        self.launches += 1
