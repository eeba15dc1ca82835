"""
Build the CUDA kernels of ``csrc/`` with ``nvcc`` and load them through
``ctypes``.

The shared library is built at first use from the package's own sources
into ``build/torch_kernels/<hash>/`` beside the package, keyed on a hash of
the sources and the compiler flags, so an edited source is rebuilt and an
unchanged one is reused. ``nvcc`` is taken from ``PATH``, else from
``$CUDA_HOME/bin``, else from ``/usr/local/cuda/bin``. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
SOURCES = ("fused_rollout.cu", "fused_rollout.cuh")
# -fmad=false: no contraction of a multiply and an add into one FMA, so the
# kernels round every operation as the plain PyTorch versions (one kernel
# per operation) do. The reactor's stratification switch (Ri > 0.25) turns
# a one-ulp density difference into a 2x change of an interface's exchange
# rate, so with FMA a float32 comparison would measure that switch instead
# of the kernel.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

_lib = None
build_info: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found on PATH, in $CUDA_HOME/bin or in "
            "/usr/local/cuda/bin: the CUDA kernels cannot be built")
    return path


def _source_hash(flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build(flags=NVCC_FLAGS) -> Path:
    """Compile the library with ``flags`` if this source hash has not been
    built yet; return its path. ``build_info`` records the seconds the build
    took and the compiler's output (``-Xptxas -v``: registers and spills)."""
    out_dir = BUILD_ROOT / _source_hash(flags)
    lib_path = out_dir / "libwt_fused_rollout.so"
    log_path = out_dir / "nvcc.log"
    if lib_path.exists():
        build_info.update(path=str(lib_path), seconds=0.0, cached=True,
                          log=log_path.read_text() if log_path.exists()
                          else "")
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libwt_fused_rollout.{os.getpid()}.so"
    cmd = [nvcc_path(), *flags, "-o", str(tmp),
           str(CSRC / "fused_rollout.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib_path)
    build_info.update(path=str(lib_path), seconds=seconds, cached=False,
                      log=log)
    return lib_path


def load():
    """The kernel library the wrappers launch, built first if needed."""
    global _lib
    if _lib is None:
        _lib = bind(build())
    return _lib


def bind(path: Path):
    """Load the library at ``path`` and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for fn in (lib.wt_rollout_fused, lib.wt_rollout_scheduled):
        fn.argtypes = [i32, ptr, ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr, ptr,
                       ptr, ptr, ptr, i32, i32, i32, i32, i32, f64, ptr]
        fn.restype = i32
    lib.wt_error_string.argtypes = [i32]
    lib.wt_error_string.restype = ctypes.c_char_p
    return lib
