"""Build and bind the CUDA kernels of ``csrc/``.

``nvcc`` compiles ``csrc/megakernel.cu`` into a shared library with a plain
C interface, which ``ctypes`` loads.  The build runs at first use, into
``build/kernels/`` beside the package, and is keyed by a hash of the source
and the flags, so an edited source rebuilds and an unchanged one loads the
library already built.  The compiler's register report (``-Xptxas -v``) is
kept beside the library in a ``.log`` file.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "megakernel.cu"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(flags: tuple[str, ...] = NVCC_FLAGS) -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"megakernel_{digest[:16]}.so"


def build(path: Path, flags: tuple[str, ...] = NVCC_FLAGS) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {res.returncode}:\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    path.with_suffix(".log").write_text(res.stdout + res.stderr)
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing


@functools.cache
def load() -> ctypes.CDLL:
    """Build the kernels if needed, load them, declare their signatures."""
    path = library_path()
    if not path.exists():
        build(path)
    return bind(path)


def bind(path: Path) -> ctypes.CDLL:
    """Load a built library and declare its signatures."""
    lib = ctypes.CDLL(str(path))
    ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
    lib.rtrt_radiance.argtypes = [ptr, ptr, i32, u32, u32, i32, i32, i32,
                                  i32, i32, i32, ptr, ptr]
    lib.rtrt_radiance.restype = i32
    lib.rtrt_uniforms.argtypes = [ptr, i32, u32, u32, u32, i32, ptr, ptr]
    lib.rtrt_uniforms.restype = i32
    lib.rtrt_error_string.argtypes = [i32]
    lib.rtrt_error_string.restype = ctypes.c_char_p
    return lib


def error_string(err: int) -> str:
    return load().rtrt_error_string(err).decode()
