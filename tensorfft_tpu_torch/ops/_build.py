"""Build and load the CUDA kernels of ``csrc/`` at first use.

The sources have a plain C interface (no PyTorch headers): ``nvcc`` compiles
each one for ``sm_90a`` in parallel and links them into a shared library,
which is loaded with ``ctypes``.  The library goes into ``tensorfft_tpu_torch/_build/``
under a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is reused.  A failed build raises with nvcc's output.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

__all__ = ["library", "build_log", "check", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# name -> argtypes; every function returns a cudaError_t code as int.
_SIGNATURES = {
    "tfft_fused_fft": [_P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _I, _P, _P,
                       _P, _P],
    "tfft_fused_fft_cols": [_P, _P, _P, _P, _I, _I, _L, _I, _L, _I, _I, _P,
                            _P, _P, _P],
    "tfft_four_step_col": [_P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _I, _P, _P,
                           _P, _P, _P, _I, _P],
    "tfft_four_step_row": [_P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _I, _P, _P,
                           _P, _P],
    "tfft_four_step_col_packed": [_P, _P, _P, _I, _I, _L, _I, _I, _I, _I, _P,
                                  _P, _P, _P, _P, _I, _P],
    "tfft_four_step_row_interleave": [_P, _P, _P, _I, _I, _L, _I, _I, _I, _I,
                                      _P, _P, _P, _P],
    "tfft_fft2_col": [_P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _I, _P, _P, _P,
                      _P],
    "tfft_fft2_row": [_P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _I, _P, _P, _P,
                      _P],
    "tfft_fused_batch_major": [_P, _P, _P, _P, _I, _I, _L, _I, _I, _I, _P, _P,
                               _P, _P],
    "tfft_pack_split": [_P, _P, _P, _I, _L, _I, _P],
    "tfft_interleave_split": [_P, _P, _P, _I, _L, _I, _P],
    "tfft_untangle_fwd": [_P, _P, _P, _P, _I, _L, _I, _P, _F, _P],
    "tfft_retangle_inv": [_P, _P, _P, _P, _I, _I, _L, _I, _P, _F, _P],
    "tfft_poisson_scale": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _L,
                           _L, _L, _L, _L, _L, _L, _I, _P],
    "tfft_spectral_product": [_P, _P, _P, _P, _P, _P, _I, _L, _L, _L, _L, _I, _P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the CUDA "
        "kernels are built from tensorfft_tpu_torch/csrc at first use"
    )


def _sources():
    return sorted(_CSRC.glob("*.cu")), sorted(_CSRC.glob("*.cuh"))


def _build_dir() -> Path:
    cus, headers = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cus + headers:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return _BUILD / h.hexdigest()[:16]


def _run(cmd, what):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed {what} (exit {proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    return proc.stdout + proc.stderr


def _timed_run(cmd, what):
    """_run, with a last line naming the source and nvcc's wall time."""
    start = time.perf_counter()
    log = _run(cmd, what)
    return f"{log}[nvcc] {Path(cmd[-1]).name} {time.perf_counter() - start:.1f} s\n"


def _compile(out: Path) -> None:
    """Compile each source to an object in parallel, then link."""
    cus, _ = _sources()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objs = [str(Path(tmp) / (c.stem + ".o")) for c in cus]
        cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-I", str(_CSRC), "-o", o, str(c)]
                for c, o in zip(cus, objs)]
        with concurrent.futures.ThreadPoolExecutor(len(cmds)) as pool:
            logs = list(pool.map(lambda cmd: _timed_run(cmd, "compiling"), cmds))
        so = str(Path(tmp) / out.name)
        _run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", so, *objs], "linking")
        (out.parent / "build.log").write_text("".join(logs))
        os.replace(so, out)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, compiled on first call."""
    so = _build_dir() / "libtfft_cuda.so"
    if not so.exists():
        _compile(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    lib.tfft_error_string.argtypes = [_I]
    lib.tfft_error_string.restype = ctypes.c_char_p
    return lib


def build_log() -> str:
    """nvcc's output (including ``-Xptxas -v``) of the library's build, and
    each source's compile time (``[nvcc] name seconds`` lines)."""
    library()
    return (_build_dir() / "build.log").read_text()


def check(err: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error code (or the code of a
    cluster the card cannot schedule)."""
    if err != 0:
        msg = library().tfft_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
