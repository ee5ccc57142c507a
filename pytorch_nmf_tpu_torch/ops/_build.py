"""Build and load the hand-written CUDA kernels of ``csrc/``.

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded through :mod:`ctypes`.  The
library lands in ``build/pytorch_nmf_tpu_torch/`` beside the package,
keyed on a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads in milliseconds.  The compiler's resource report
(registers, shared memory, spills per kernel) is kept beside it as
``.log``.  Nothing here runs at import.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["load_library"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pytorch_nmf_tpu_torch"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# every C entry point: (argtypes, restype)
_SIGNATURES = {
    "pnt_contract_splits": ([_I, _I, _I, _I], _I),
    "pnt_loss_splits": ([_I, _I, _I], _I),
    "pnt_loss_partials": ([_I, _I], _I),
    "pnt_fused_contractions": (
        [_P] * 8 + [_I, _I, _I, _L, _L, _I, _F, _I, _P], _I),
    "pnt_fused_beta_loss": ([_P] * 5 + [_I, _I, _I, _I, _F, _P], _I),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: set CUDA_HOME to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def load_library() -> ctypes.CDLL:
    """Return the loaded ``csrc/fused_mu.cu`` library, building it first if
    no library for these exact sources exists yet."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        src = _CSRC / "fused_mu.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(_NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        so = _BUILD_DIR / f"libfused_mu-{digest}.so"
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(src)],
                    capture_output=True, text=True,
                )
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed to build {src.name}:\n{proc.stderr}"
                    )
                # ptxas' registers / shared memory / spills per kernel
                so.with_suffix(".log").write_text(proc.stderr)
                os.replace(tmp, so)  # atomic: concurrent builders agree
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _lib = lib
        return lib
