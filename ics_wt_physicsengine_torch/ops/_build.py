"""
Build the CUDA kernels of ``csrc/`` with ``nvcc`` and load them through
``ctypes``.

Each ``.cu`` source becomes one shared library, built at first use from the
package's own sources into ``build/torch_kernels/<hash>/`` beside the
package. The hash covers every source and the compiler flags, so an edited
source is rebuilt and an unchanged one is reused. All libraries are built
together, one ``nvcc`` process each, started at the same time. ``nvcc`` is
taken from ``PATH``, else from ``$CUDA_HOME/bin``, else from
``/usr/local/cuda/bin``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "torch_kernels"
# library name -> its .cu source; the headers are shared
LIBRARIES = {"fused_rollout": "fused_rollout.cu",
             "fused_plant": "fused_plant.cu",
             "ph_solver": "ph_solver.cu"}
HEADERS = ("fused_rollout.cuh", "philox.cuh", "sensors.cuh",
           "ph_newton.cuh")
# -fmad=false: no contraction of a multiply and an add into one FMA, so the
# kernels round every operation as the plain PyTorch versions (one kernel
# per operation) do. The reactor's stratification switch (Ri > 0.25) turns
# a one-ulp density difference into a 2x change of an interface's exchange
# rate, and the sensors compare against thresholds, so with FMA a float32
# comparison would measure those switches instead of the kernel.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v")

_libs: dict = {}
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
    for name in (*LIBRARIES.values(), *HEADERS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _build_one(name: str, out_dir: Path, flags) -> dict:
    lib_path = out_dir / f"libwt_{name}.so"
    log_path = out_dir / f"nvcc_{name}.log"
    if lib_path.exists():
        return dict(path=str(lib_path), seconds=0.0, cached=True,
                    log=log_path.read_text() if log_path.exists() else "")
    tmp = out_dir / f"libwt_{name}.{os.getpid()}.so"
    cmd = [nvcc_path(), *flags, "-o", str(tmp), str(CSRC / LIBRARIES[name])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {LIBRARIES[name]} "
                           f"({proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, lib_path)
    return dict(path=str(lib_path), seconds=seconds, cached=False, log=log)


def build(flags=NVCC_FLAGS) -> dict:
    """Compile every library with ``flags`` (those this source hash has not
    built yet, in parallel); return ``{name: path}``. ``build_info`` records
    per library the seconds its build took and the compiler's output
    (``-Xptxas -v``: registers and spills), and the wall seconds of all."""
    out_dir = BUILD_ROOT / _source_hash(flags)
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        infos = list(pool.map(lambda n: _build_one(n, out_dir, flags),
                              LIBRARIES))
    build_info.update(dict(zip(LIBRARIES, infos)),
                      seconds=time.perf_counter() - t0)
    return {name: Path(info["path"]) for name, info in zip(LIBRARIES, infos)}


def load(name: str = "fused_rollout"):
    """The kernel library ``name`` that the wrappers launch, built first
    (with every other library) if needed."""
    if name not in _libs:
        _libs.update({n: bind(n, path) for n, path in build().items()})
    return _libs[name]


def use(libs: dict) -> None:
    """Make ``libs`` (``{name: bound library}``) the libraries the wrappers
    launch: for comparing two builds within one process."""
    _libs.update(libs)


def bind(name: str, path: Path):
    """Load library ``name`` at ``path`` and declare its C interface."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, f64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    u64 = ctypes.c_ulonglong
    if name == "fused_rollout":
        for fn in (lib.wt_rollout_fused, lib.wt_rollout_scheduled):
            fn.argtypes = [i32, ptr, ptr, ptr, i32, ptr, ptr, ptr, ptr, ptr,
                           ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, f64,
                           i32, i32, i32, ptr]
            fn.restype = i32
        lib.wt_error_string.argtypes = [i32]
        lib.wt_error_string.restype = ctypes.c_char_p
    elif name == "fused_plant":
        lib.wt_plant_rollout.argtypes = (
            [i32, ptr, ptr, i32, ptr, i32]      # type, tables, rkc, stages
            + [ptr] * 5 + [u64]                 # sensor tables, words, seed
            + [ctypes.c_uint] * 2               # step0, plant0
            + [ptr] * 14                        # time, state, outputs
            + [i32] * 8 + [f64, f64, ptr])      # sizes, h_step, dt, stream
        lib.wt_plant_rollout.restype = i32
        lib.wt_philox_words.argtypes = [u64, i32, i32, ptr, ptr]
        lib.wt_philox_words.restype = i32
        lib.wt_plant_error_string.argtypes = [i32]
        lib.wt_plant_error_string.restype = ctypes.c_char_p
    elif name == "ph_solver":
        lib.wt_solve_ph.argtypes = (
            [i32] + [ptr] * 8                   # type, 7 inputs, output
            + [ctypes.c_longlong, i32, f64]     # n, iters, tolerance
            + [i32, i32, ptr, ptr])             # grid, work, stream
        lib.wt_solve_ph.restype = i32
        lib.wt_ph_blocks_per_sm.argtypes = [i32, i32]
        lib.wt_ph_blocks_per_sm.restype = i32
        lib.wt_ph_error_string.argtypes = [i32]
        lib.wt_ph_error_string.restype = ctypes.c_char_p
    else:
        raise ValueError(f"unknown kernel library {name!r}")
    return lib
