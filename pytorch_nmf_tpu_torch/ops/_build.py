"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each source ``csrc/<name>.cu`` is compiled at first use with ``nvcc`` for
``sm_90a`` into a shared library of its own with a plain C interface, loaded
through :mod:`ctypes`.  The libraries land in ``build/pytorch_nmf_tpu_torch/``
beside the package, keyed on a hash of their source, the shared headers
``csrc/*.cuh`` and the flags, so an edited source or header rebuilds and an
unchanged one loads in milliseconds.  The compiler's resource report
(registers, shared memory, spills per kernel) is kept beside each as
``.log``.  :func:`load_all` starts one ``nvcc`` per source, all at once.
Nothing here runs at import.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ["load_library", "load_all"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pytorch_nmf_tpu_torch"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# every C entry point of each source: (argtypes, restype)
_SIGNATURES = {
    "fused_mu": {
        "pnt_contract_splits": ([_I, _I, _I, _I], _I),
        "pnt_loss_splits": ([_I] * 4, _I),
        "pnt_loss_partials": ([_I, _I], _I),
        "pnt_fused_contractions": ([_P] * 8 + [_I] * 7 + [_F, _I, _I, _P], _I),
        "pnt_fused_beta_loss": ([_P] * 5 + [_I] * 6 + [_F, _I, _P], _I),
    },
    "fused_deconv": {
        "pnt_hgrad": ([_P] * 5 + [_I] * 20 + [_P], _I),
        "pnt_wgrad_splits": ([_I, _I, _I, _I, _I], _I),
        "pnt_wgrad": ([_P] * 9 + [_I] * 14 + [_P], _I),
    },
    "hoyer_proj": {
        "pnt_hoyer_proj_setup": ([ctypes.POINTER(_I)], _I),
        "pnt_hoyer_proj": ([_P] * 5 + [_I] * 8 + [_P], _I),
        "pnt_hoyer_proj_occupancy": ([_I] * 5 + [ctypes.POINTER(_I)], _I),
    },
    "graph_cond": {
        "pnt_while_begin": ([_P, _P, _P, ctypes.POINTER(ctypes.c_ulonglong)],
                            _I),
        "pnt_while_end": ([_P, ctypes.c_ulonglong, _P], _I),
        "pnt_stream_create": ([ctypes.POINTER(_P)], _I),
        "pnt_stream_destroy": ([_P], _I),
    },
}

_lock = threading.Lock()
_libs = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("CUDA toolkit not found: set CUDA_HOME to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _library_path(name: str) -> Path:
    """The library's path, keyed on its source, every shared header of
    ``csrc/`` and the flags."""
    sources = [_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in sources) + " ".join(_NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return _BUILD_DIR / f"lib{name}-{digest}.so"


def _build(names) -> None:
    """Start one ``nvcc`` for each source without a current library, all at
    once, and wait for every one of them."""
    jobs = []
    for name in names:
        so = _library_path(name)
        if so.exists():
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(_CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        jobs.append((name, so, tmp, proc))
    errors = []
    for name, so, tmp, proc in jobs:
        _, stderr = proc.communicate()
        try:
            if proc.returncode != 0:
                errors.append(f"nvcc failed to build {name}.cu:\n{stderr}")
            else:
                # ptxas' registers / shared memory / spills per kernel
                so.with_suffix(".log").write_text(stderr)
                os.replace(tmp, so)  # atomic: concurrent builders agree
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    if errors:
        raise RuntimeError("\n".join(errors))


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_library_path(name)))
    for fn, (argtypes, restype) in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def load_library(name: str) -> ctypes.CDLL:
    """Return the loaded library of ``csrc/<name>.cu``, building it first if
    no library for this exact source exists yet."""
    with _lock:
        if name not in _libs:
            _build([name])
            _libs[name] = _load(name)
        return _libs[name]


def load_all() -> dict:
    """Build every source in parallel where needed and load them all."""
    with _lock:
        missing = [n for n in _SIGNATURES if n not in _libs]
        _build(missing)
        for name in missing:
            _libs[name] = _load(name)
        return dict(_libs)
