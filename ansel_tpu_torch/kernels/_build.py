"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` into `build/ansel_tpu_torch/lib<name>-<key>.so` at the root of the
checkout, where <key> hashes the source and the flags, so an edit or a
flag change rebuilds and an unchanged tree reuses the library.  No
PyTorch header is included, which keeps a build to seconds.

Nothing here falls back: a missing `nvcc` or a failed build raises.
`load` holds a lock, so a kernel's first use may come from any thread
(the scheduler's device worker, `control/jobs.py`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ansel_tpu_torch"
KERNELS = ("rcd", "pointwise_chain", "sepblur", "eaw", "nlm", "iir",
           "diffuse", "markesteijn", "warp", "bgrid")

# --fmad=false and no --use_fast_math: the kernels round like their plain
# torch versions, operation for operation.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_LIBS = {}
_LOCK = threading.Lock()
# the wrappers add to their launch counts under this lock: the shards of
# a mesh (parallel/mesh.py) launch kernels from threads side by side
COUNT_LOCK = threading.Lock()


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, /usr/local/cuda/bin, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library exists; -> library path."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # one temporary file per process and thread: a device worker's first
    # load may build beside `build_all` on the main thread
    tmp = out.with_name(
        f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LIBS[name] = lib
        return lib


def build_all() -> float:
    """Build every kernel of the package, one nvcc per source, all
    started together, then load them; -> seconds taken."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        for future in [pool.submit(build, name) for name in KERNELS]:
            future.result()
    for name in KERNELS:
        load(name)
    return time.perf_counter() - t0
