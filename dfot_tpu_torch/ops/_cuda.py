"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

The sources under ``dfot_tpu_torch/csrc/`` expose plain C entry points, so
nvcc builds them in seconds (no PyTorch headers): one ``nvcc -c`` per source,
all started together, then one link. The library is built at first use into
``build/dfot_tpu_torch/`` at the root of the checkout, named by a hash of the
sources so an edited kernel is rebuilt, and loaded once per process. Every C
entry returns a ``cudaError_t``; :func:`check` turns a non-zero code into an
exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dfot_tpu_torch"
_SOURCES = (
    "flash_fwd.cu", "flash_bwd.cu", "flash_wide.cu", "qkv_prep.cu", "qkv_prep_bwd.cu",
    "attn_out_collect.cu", "attn_out_scatter.cu", "ln_modulate.cu", "small_n_attn.cu",
)
_HEADERS = ("hopper.cuh",)
_ARCH = "arch=compute_90a,code=sm_90a"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the entry points (every one returns a cudaError_t as int)
_SIGNATURES = {
    "dfot_flash_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "dfot_qkv_prep": (_P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    "dfot_attn_out_collect": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "dfot_flash_bwd_dq": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "dfot_flash_bwd_dkv": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "dfot_qkv_prep_bwd": (
        _P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _L, _L, _P, _P, _P, _P,
        _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _I, _L, _P,
    ),
    "dfot_attn_out_scatter": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    "dfot_ln_modulate_fwd": (_P, _P, _P, _P, _L, _I, _F, _I, _I, _I, _L, _P),
    "dfot_ln_modulate_bwd": (_P, _P, _P, _P, _P, _L, _I, _F, _I, _I, _I, _L, _P),
    "dfot_small_n_attn": (_P, _P, _P, _P, _L, _I, _I, _F, _I, _I, _I, _I, _I, _L, _P),
    "dfot_small_n_attn_wide": (_P, _P, _P, _P, _L, _I, _I, _F, _I, _I, _I, _I, _I, _L, _P),
    "dfot_ring_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    "dfot_ring_bwd_dq": (
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    "dfot_ring_bwd_dkv": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I, _P),
    "dfot_flash_fwd_wide": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    "dfot_flash_bwd_dq_wide": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I,
                               _P),
    "dfot_flash_bwd_dkv_wide": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                                _I, _P),
    "dfot_ring_fwd_wide": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I,
                           _I, _P),
    "dfot_ring_bwd_dq_wide": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                              _I, _I, _I, _P),
    "dfot_ring_bwd_dkv_wide": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _F, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib = None
# filled by the first build in this process: seconds spent in nvcc (0 when
# the library was already on disk) and the compiler's -Xptxas -v report
build_info = {"seconds": None, "log": "", "path": None}


def _nvcc() -> str:
    candidates = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        candidates.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def _build() -> Path:
    sources = [_CSRC / s for s in _SOURCES]
    hashed = sources + [_CSRC / h for h in _HEADERS]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in hashed)).hexdigest()[:16]
    out = _BUILD_DIR / f"libdfot_kernels_{digest}.so"
    build_info["path"] = str(out)
    if out.exists():
        build_info["seconds"] = 0.0
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{digest}.{os.getpid()}"
    objects = [_BUILD_DIR / f"{s.stem}.{tag}.o" for s in sources]
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    try:
        compiles = [
            subprocess.Popen(
                [nvcc, "-gencode", _ARCH, "-std=c++17", "-O3", "-c", "-Xcompiler", "-fPIC",
                 "-Xptxas", "-v", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objects)
        ]
        logs = [proc.communicate()[0] for proc in compiles]
        build_info["log"] = "".join(f"== {s.name}\n{log}" for s, log in zip(sources, logs))
        failed = [s.name for s, proc in zip(sources, compiles) if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{build_info['log']}")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(o) for o in objects)],
            capture_output=True, text=True,
        )
        build_info["log"] += link.stdout + link.stderr
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{build_info['log']}")
        os.replace(tmp, out)
    finally:
        build_info["seconds"] = time.perf_counter() - t0
        for obj in objects:
            obj.unlink(missing_ok=True)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built from ``csrc/`` on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(_build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}")


def check_aligned(what: str, nbytes: int, *tensors) -> None:
    """Raise unless every tensor's data starts on an ``nbytes`` boundary
    (the kernels' vector loads and stores assume it)."""
    for t in tensors:
        if t.data_ptr() % nbytes:
            raise ValueError(f"{what}: data at {t.data_ptr():#x} is not {nbytes}-byte aligned")


def stream_handle(device) -> int:
    """PyTorch's current stream on ``device``, as the raw handle the C
    entry points take."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
