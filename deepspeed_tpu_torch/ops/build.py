"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries go to ``ops/build/`` beside
this file (listed in ``.gitignore``) under a name that carries a digest of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source is always rebuilt and a stale library is never loaded. :func:`build` starts one ``nvcc`` per
missing library, all at once, and waits for them; :func:`load` builds on
first use.

Nothing here runs at import time: modules that hold kernels import on a
host without ``nvcc`` or a GPU, and only a launch builds.
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
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
KERNELS = ("paged_attention", "quant_matmul", "decode_attention",
           "flash_attention_fwd", "flash_attention_bwd",
           "block_sparse_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_sms: Dict[int, int] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "deepspeed_tpu_torch are built from source at first use")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):     # shared tile helpers
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> float:
    """Compile every missing library of ``names`` (default: all kernels) in
    parallel. Returns the wall seconds spent; raises with nvcc's output if
    a build fails. The compiler's resource report (``-Xptxas=-v``) is kept
    next to each library as ``<library>.log``."""
    names = list(KERNELS if names is None else names)
    t0 = time.perf_counter()
    with _lock:
        todo = [n for n in names if not library_path(n).exists()]
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for n in todo:
            out = library_path(n)
            tmp = out.with_suffix(f".tmp{os.getpid()}")
            procs.append((n, out, tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed = []
        for n, out, tmp, p in procs:
            log, _ = p.communicate()
            out.with_suffix(".so.log").write_text(log)
            if p.returncode != 0:
                failed.append(f"--- {n}.cu (nvcc rc {p.returncode}) ---\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output for the current build of ``name`` ('' if none)."""
    log = library_path(name).with_suffix(".so.log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(library_path(name)))
                _libs[name] = lib
    return lib


def sm_count(dev) -> int:
    """The SM count of CUDA device ``dev``, cached per device (the kernels'
    launch plans size their grids by it)."""
    import torch
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    n = _sms.get(idx)
    if n is None:
        n = _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return n


def check(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if kernel ``name``'s C entry point returned an error: the
    launch was refused (``cudaGetLastError``) or the combination of types
    has no kernel. Each library exports ``<name>_error_string``."""
    if err != 0:
        fn = getattr(lib, f"{name}_error_string")
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{name} kernel launch failed: error {err} "
                           f"({fn(err).decode()})")
