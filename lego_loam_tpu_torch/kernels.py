"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

The sources have a plain C interface and include none of PyTorch's headers,
so ``nvcc`` builds them in seconds.  They are compiled for ``sm_90a`` at
first use — one ``nvcc -c`` per source, all started together, then one link
— into ``build/libkernels.so`` beside the package (or under
``$LEGO_TORCH_BUILD_DIR``) and loaded with ``ctypes``.  A content hash of
the sources sits beside the library, so a changed source rebuilds.

Nothing here runs at import time: machines without ``nvcc`` import every
module of the package and only fail when a kernel is actually asked for.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = ("label.cu", "knn5.cu", "noop.cu")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
build_seconds: Optional[float] = None   # set when this process built the library
build_logs: dict = {}                   # source -> ptxas output of a verbose build


def build_dir() -> str:
    return os.environ.get(
        "LEGO_TORCH_BUILD_DIR",
        os.path.join(os.path.dirname(CSRC), os.pardir, "build"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def build(verbose: bool = False, force: bool = False) -> str:
    """Compile ``csrc/*.cu`` into ``libkernels.so``; returns its path.
    An up-to-date library is kept unless ``force``; ``verbose`` prints what
    ``ptxas`` says of each kernel (registers, shared memory, spills) and
    keeps it in ``build_logs``."""
    global build_seconds
    digest = _digest()
    out_dir = os.path.abspath(build_dir())
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libkernels.so")
    stamp_path = lib_path + ".sha256"
    if not force and os.path.exists(lib_path) and os.path.exists(stamp_path):
        with open(stamp_path) as f:
            if f.read().strip() == digest:
                return lib_path

    t0 = time.time()
    nvcc = _nvcc()
    flags = _NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
    procs, objs = [], []
    for name in SOURCES:
        obj = os.path.join(out_dir, f"{name}.{os.getpid()}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *flags, "-c", os.path.join(CSRC, name), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    for name, p, log in zip(SOURCES, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        if verbose and log:
            build_logs[name] = log
            print(log, flush=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    link = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)
    for obj in objs:
        os.remove(obj)
    with open(stamp_path, "w") as f:
        f.write(digest)
    build_seconds = time.time() - t0
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, once however many
    threads ask at the same time)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            cdll = ctypes.CDLL(build())
            p, i = ctypes.c_void_p, ctypes.c_int
            # int label_ccl(labels0, right, down, out, B, V, H, edge_bytes,
            #               stream)
            cdll.label_ccl.argtypes = [p, p, p, p, i, i, i, i, p]
            cdll.label_ccl.restype = i
            # int knn5_batch(const Batch* batch, total_blocks, stream);
            # int knn5_query_block()
            cdll.knn5_batch.argtypes = [p, i, p]
            cdll.knn5_batch.restype = i
            cdll.knn5_query_block.argtypes = []
            cdll.knn5_query_block.restype = i
            # int noop_launch(stream): an empty kernel, for the launch floor
            cdll.noop_launch.argtypes = [p]
            cdll.noop_launch.restype = i
            _lib = cdll
    return _lib
