"""Build the CUDA kernels from ``repro_torch/csrc`` and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use by ``nvcc`` into its own shared library, loaded with :mod:`ctypes`:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so \\
         csrc/<name>.cu

The file name carries a hash of the sources and flags, so an edited source
is rebuilt and a stale library is never loaded.  ``build()`` starts one
``nvcc`` per missing source, all at once, and waits for them together.
The ``-Xptxas -v`` report (registers, spills) is kept beside each library.
Nothing here runs at import: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess  # runs nvcc, not fleet I/O  # gflint: disable=GFL008
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("fold_norms", "fold_apply", "graph_combine", "secure_agg",
           "swa_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _I64, _F, _U32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                          ctypes.c_float, ctypes.c_uint32)
# the C interface of each source: entry point, argument types (pointers and
# the stream as c_void_p, so ctypes never cuts them to 32 bits); every entry
# point returns a cudaError_t as int
SIGNATURES = {
    "fold_norms": ("gfl_fold_norms",
                   [_P, _I, _P, _P, _I, _I64, _I64, _I, _P]),
    "fold_apply": ("gfl_fold_apply",
                   [_P, _I, _I, _P, _I, _P, _P, _P, _I, _F, _P, _P, _P, _I,
                    _I, _I64, _P]),
    "graph_combine": ("gfl_graph_combine",
                      [_P, _P, _P, _P, _P, _P, _I, _I, _I64, _P]),
    "secure_agg": ("gfl_pair_streams", [_U32, _F, _P, _I, _I64, _P]),
    "swa_decode": ("gfl_swa_decode",
                   [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I64, _I64,
                    _F, _P]),
}

_FUNCS: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first "
                       "use and need the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def report_path(name: str) -> Path:
    return library_path(name).with_suffix(".log")


def build(names=SOURCES) -> dict:
    """Compile every listed source whose library is missing, in parallel.
    Returns {name: library path}; raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        lib = library_path(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, lib)
    failed = []
    for name, (proc, tmp, lib) in jobs.items():
        out, _ = proc.communicate()
        lib.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def function(name: str):
    """The C entry point of ``csrc/<name>.cu``, built and loaded on first
    use, with its argument and result types declared."""
    fn = _FUNCS.get(name)
    if fn is None:
        path = build([name])[name]
        symbol, argtypes = SIGNATURES[name]
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
