"""Build and load the CUDA kernels under ``csrc/``.

``nvcc`` compiles every ``csrc/*.cu`` for ``sm_90a`` (one process per source,
and one per entry of the sources in ``_PARTS``, all started together), links
them into ``build/libauxpm_kernels.so`` next to
the package, and ``ctypes`` loads it.  The sources have a plain C interface:
pointers come from ``tensor.data_ptr()``, the stream from
``torch.cuda.current_stream().cuda_stream``.  The build happens at first use,
never at import, and is redone when a source's hash changes.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_LIB_NAME = "libauxpm_kernels.so"
# sources compiled in parts, part k with -DAUXPM_ENTRY=k: source -> parts
_PARTS = {"fused_estimator.cu": 4}
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_int64
# name -> argtypes; every function returns the cudaError_t of its launch
_SIGNATURES = {
    "auxpm_fused_estimate": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I,
                             _P],
    "auxpm_fused_estimate_rot": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                 _I, _I, _I, _F, _I, _I, _P],
    "auxpm_fused_weights": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "auxpm_fused_rot_weights": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                _I, _I, _I, _I, _P],
    "auxpm_se_gram_ard": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "auxpm_ess_sweep": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _F, _I, _I, _P],
    "auxpm_sweep_grid": [],
    "auxpm_cooperative_launch_check": [_I],
    "auxpm_sigma_sweep": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _F, _I, _I, _P],
    "auxpm_chol_panel": [_P, _P, _P, _I, _P],
    "auxpm_chol_panel_v1": [_P, _P, _P, _I, _P],
    "auxpm_chol_panel_v2": [_P, _P, _I, _P],
    "auxpm_threefry": [_P, _P, _L, _L, _L, _I, _F, _F, _F, _P, _P],
}

_lib = None


def _find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc:
        return nvcc
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of auxpm_tpu_torch cannot be built on this machine"
    )


def _source_hash(sources):
    h = hashlib.sha256((" ".join(_NVCC_FLAGS) + repr(_PARTS)).encode())
    for path in sources:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()


def _run_all(commands):
    """Start every command at once, wait for all, raise on the first failure
    with the compiler's output.  Returns the combined output."""
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for cmd in commands
    ]
    outputs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(commands, procs, outputs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"kernel build failed ({' '.join(cmd)}):\n{out}"
            )
    return "\n".join(outputs)


def build(force=False):
    """Compile ``csrc/*.cu`` into the shared library if it is missing or
    stale; return its path.  Processes that get here together (the ranks of a
    sharded run) take turns behind a file lock: the first builds, the others
    find the library fresh."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(_BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_locked(force)


def _build_locked(force):
    cu = sorted(_CSRC.glob("*.cu"))
    if not cu:
        raise RuntimeError(f"no CUDA sources under {_CSRC}")
    digest = _source_hash(cu + sorted(_CSRC.glob("*.cuh")))
    lib_path = _BUILD_DIR / _LIB_NAME
    stamp = _BUILD_DIR / (_LIB_NAME + ".sha256")
    if (
        not force
        and lib_path.exists()
        and stamp.exists()
        and stamp.read_text().strip() == digest
    ):
        return lib_path
    nvcc = _find_nvcc()
    jobs = [(src, [], _BUILD_DIR / (src.stem + ".o")) for src in cu
            if src.name not in _PARTS]
    jobs += [(src, [f"-DAUXPM_ENTRY={k}"], _BUILD_DIR / f"{src.stem}.{k}.o")
             for src in cu for k in range(_PARTS.get(src.name, 0))]
    objects = [obj for _, _, obj in jobs]
    log = _run_all(
        [[nvcc, *_NVCC_FLAGS, *defs, "-c", str(src), "-o", str(obj)]
         for src, defs, obj in jobs]
    )
    log += _run_all(
        [[nvcc, "-shared", "-o", str(lib_path), *map(str, objects)]]
    )
    (_BUILD_DIR / "nvcc.log").write_text(log)  # registers, shared memory, spills
    stamp.write_text(digest)
    return lib_path


def load_library():
    """The loaded kernel library (built on first call), ``argtypes`` set."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_launch(err, what):
    """Raise if a kernel's launch was refused (``err`` = its cudaError_t)."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {err}")


def require_f32_contiguous(**tensors):
    """Raise unless every tensor is float32, contiguous, on one CUDA device
    and 16-byte aligned (the kernels load float4)."""
    import torch

    device = None
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name}: expected a CUDA tensor")
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: data pointer is not 16-byte aligned")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: on {t.device}, expected {device}")
    return device
