"""Build and bind the CUDA kernels of ``csrc/``.

Each kernel source (``csrc/*.cu``, all including ``csrc/radiance.cuh``,
the two BVH walks also ``csrc/bvh_walk.cuh``) is compiled by ``nvcc`` into
a shared library of its own with a plain C interface, which ``ctypes``
loads.  A build runs at first use, into ``build/kernels/`` beside the
package, and is keyed by a hash of the source, the headers and the flags, so an edited source rebuilds and an
unchanged one loads the library already built.  The first :func:`load` that
finds its library missing builds every missing one, one ``nvcc`` per
source, all started together.  The compiler's register report
(``-Xptxas -v``) is kept beside each library in a ``.log`` file.
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
_CSRC = _PKG / "csrc"
# library name -> its source
SOURCES = {
    "megakernel": _CSRC / "megakernel.cu",        # forward radiance
    "radiance_grad": _CSRC / "radiance_grad.cu",  # its backward
    "mse_loss": _CSRC / "mse_loss.cu",            # fused loss + gradient
    "bvh_forward": _CSRC / "bvh_forward.cu",      # forward over the BVH
    "fetch_rows": _CSRC / "fetch_rows.cu",        # winner rows, transpose
    "occlusion": _CSRC / "occlusion.cu",          # shadow rays, any hit
}
HEADERS = (_CSRC / "radiance.cuh", _CSRC / "bvh_walk.cuh")
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_P, _I32, _I64, _U32, _F32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_int64, ctypes.c_uint32,
                              ctypes.c_float)
# C entry -> (argument types, result type)
_SIGNATURES = {
    "rtrt_radiance": ([_P, _P, _I32, _U32, _U32, _I32, _I32, _I32, _I32,
                       _I32, _I32, _I32, _I32, _I32]
                      + [_P, _I32, _I32, _P, _I32]  # the triangles
                      + [_P, _I32, _I32, _P, _P, _P], _I32),
    "rtrt_uniforms": ([_P, _I32, _U32, _U32, _U32, _I32, _P, _P], _I32),
    "rtrt_radiance_grad": ([_P, _P, _I32, _U32, _U32, _I32, _I32, _I32, _I32,
                            _I32, _I32, _I32, _I32, _I32]
                           + [_P, _I32, _I32, _P, _I32]  # the triangles
                           + [_P, _I32, _I32, _P, _P, _P, _I32, _P, _P],
                           _I32),
    "rtrt_mse_loss": ([_P, _P, _I32, _U32, _U32, _I32, _I32, _I32, _I32,
                       _I32, _I32, _I32, _I32, _I32]
                      + [_P, _I32, _I32, _P, _I32]  # the triangles
                      + [_F32, _P, _P, _I32, _P, _P], _I32),
    "rtrt_bvh_radiance": ([_P, _P, _P, _I32]
                          + [_P] * 5 + [_I32]    # the sphere tree
                          + [_P] * 7 + [_I32]    # the volume tree
                          + [_P] * 5 + [_I32]    # the triangle tree
                          + [_I32, _P, _P, _P, _I32, _I32, _U32, _U32, _I32,
                             _I32, _I32, _I32, _I32, _I32, _P, _P, _I32,
                             _I32, _I32, _P, _I32, _I32, _I32]
                          + [_P] * 7 + [_I32] * 3  # the mesh volumes
                          + [_P] * 6 + [_I32]  # the small trees
                          + [_P], _I32),
    "rtrt_fetch_rows": ([_P, _I64] + [_P] * 4 + [_I32, _P, _P, _I32, _I32,
                                                  _P, _P, _I32, _P, _I32, _P],
                        _I32),
    "rtrt_fetch_rows_transpose": ([_P, _I64, _P, _P, _I32, _I32, _P, _I32,
                                   _I32, _I32, _I32, _P, _I32]
                                  + [_I32] * 4  # the plan
                                  + [_P] * 7, _I32),
    "rtrt_occlusion": ([_P] * 5 + [_I32] + [_P] * 7 + [_I32] + [_P] * 5
                       + [_I32, _I32, _I32, _P, _U32, _U32, _U32, _P, _P,
                          _I32, _P]
                       + [_P] * 6 + [_I32]  # the small trees
                       + [_P], _I32),
    "rtrt_error_string": ([_I32], ctypes.c_char_p),
}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(flags: tuple[str, ...] = NVCC_FLAGS,
                 name: str = "megakernel") -> Path:
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in (
        SOURCES[name], *HEADERS)) + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"{name}_{digest[:16]}.so"


def _start(path: Path, flags, name: str):
    """Start nvcc on one source; -> (process, temporary output, command)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, cmd


def _finish(path: Path, proc, tmp: Path, cmd) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}:\n"
                           f"{' '.join(cmd)}\n{out}")
    path.with_suffix(".log").write_text(out)
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing


def build(path: Path, flags: tuple[str, ...] = NVCC_FLAGS,
          name: str = "megakernel") -> None:
    _finish(path, *_start(path, flags, name))


def _build_missing(flags: tuple[str, ...] = NVCC_FLAGS) -> None:
    """Build every library not built yet, one nvcc per source, all started
    together; raises after all have ended if any failed."""
    jobs = [(path, *_start(path, flags, name)) for name in SOURCES
            if not (path := library_path(flags, name)).exists()]
    errors = []
    for job in jobs:
        try:
            _finish(*job)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


@functools.cache
def load(name: str = "megakernel") -> ctypes.CDLL:
    """Load one library and declare its signatures; if it is not built
    yet, build it and every other missing one first."""
    path = library_path(name=name)
    if not path.exists():
        _build_missing()
    return bind(path)


def bind(path: Path) -> ctypes.CDLL:
    """Load a built library and declare the signatures of its entries."""
    lib = ctypes.CDLL(str(path))
    for entry, (args, res) in _SIGNATURES.items():
        if hasattr(lib, entry):
            fn = getattr(lib, entry)
            fn.argtypes = args
            fn.restype = res
    return lib


def error_string(err: int) -> str:
    return load().rtrt_error_string(err).decode()
