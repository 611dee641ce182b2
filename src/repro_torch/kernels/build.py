"""Build and load the hand-written CUDA kernels (no reference counterpart).

``load()`` compiles every ``csrc/*.cu`` for ``sm_90a`` with ``nvcc`` -- one
compiler process per source, all started together -- links the objects into
one shared library with a plain C interface, and opens it with ``ctypes``.
Nothing here includes PyTorch's headers, so a build takes seconds.

The library lands in ``build/repro_torch_kernels/`` at the root of the
checkout (``$REPRO_TORCH_BUILD_DIR`` overrides), under a name keyed by a
hash of the sources and flags, so an edited source rebuilds and an unchanged
one is reused.  Build and load happen at the first kernel launch, never at
import: every module of the package imports on a machine with no ``nvcc``
and no GPU.  A failed build raises with the compiler's output.
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
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
ENV_BUILD_DIR = "REPRO_TORCH_BUILD_DIR"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: float = 0.0      # wall time of the build this process ran
build_log: str = ""             # compiler output (register/shared-memory use)


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


def build_dir() -> Path:
    env = os.environ.get(ENV_BUILD_DIR)
    if env:
        return Path(env)
    # src/repro_torch/kernels/build.py -> checkout root
    return Path(__file__).resolve().parents[3] / "build" / \
        "repro_torch_kernels"


def find_nvcc() -> str:
    cands = [shutil.which("nvcc")]
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise KernelBuildError(
        "nvcc not found (looked on PATH, $CUDA_HOME, /usr/local/cuda): the "
        "CUDA kernels of repro_torch are compiled on the machine that runs "
        "them")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):        # .cu and .cuh
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(out: Path) -> None:
    global build_seconds, build_log
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    t0 = time.perf_counter()
    procs = []
    for src in sources():
        obj = out.parent / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, obj, cmd, proc in procs:
        text, _ = proc.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{text}")
        if proc.returncode != 0:
            failed.append(src.name)
    objs = [obj for _, obj, _, _ in procs]
    try:
        if failed:
            raise KernelBuildError(
                f"nvcc failed on {', '.join(failed)}:\n" + "\n".join(logs))
        tmp = out.parent / f"{tag}.so"
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        link = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        logs.append(f"$ {' '.join(cmd)}\n{link.stdout}")
        if link.returncode != 0:
            raise KernelBuildError("link failed:\n" + "\n".join(logs))
        os.replace(tmp, out)        # atomic: a concurrent loader sees all
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)


def load() -> ctypes.CDLL:
    """The kernels' shared library, built first if this checkout's sources
    have not been built yet."""
    global _lib
    with _lock:
        if _lib is None:
            out = build_dir() / f"librepro_torch_kernels_{_digest()}.so"
            if not out.exists():
                _build(out)
            _lib = ctypes.CDLL(str(out))
        return _lib
