"""Build, load and count the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``<name>-<source hash>.so`` at first use, then loaded with ``ctypes``.
The build directory is ``_build/`` inside this package (listed in
``.gitignore``). A library whose sources
changed gets a new hash and is rebuilt; nothing is read from outside the
package's own sources.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a non-zero code. ``launch_counts`` holds one plain
integer per kernel, incremented by its wrapper where it launches;
``head_dim_launches`` the attention kernels' launches by (kernel, head
dim), incremented at the same place (one template instance a head dim).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = {
    "flash_attn_fwd": "flash_attn_fwd.cu",
    "flash_attn_bwd": "flash_attn_bwd.cu",
    "flash_attn_bwd_fma": "flash_attn_bwd_fma.cu",
    "group_norm_silu": "group_norm_silu.cu",
    "int8_conv": "int8_conv.cu",
}
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

# kernel name -> launches since the last reset (wrappers increment these)
launch_counts = {"flash_attn_fwd": 0, "flash_attn_bwd_pre": 0, "flash_attn_bwd": 0,
                 "flash_attn_bwd_post": 0, "gn_stats": 0, "gn_silu_norm": 0,
                 "int8_absmax": 0, "int8_quantize": 0, "int8_conv3x3": 0, "int8_matmul": 0}
# (attention kernel name, head dim) -> launches since the last reset
head_dim_launches: collections.Counter = collections.Counter()
_libs: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0
    head_dim_launches.clear()


def build_dir() -> Path:
    return CSRC.parent / "_build"


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        h.update(src.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=None) -> dict[str, float]:
    """Compile the named libraries (default: all) that are not built yet,
    one ``nvcc`` per source, all started together. Returns the seconds
    each build took (0.0 where the library was already there) and writes
    each compiler log beside its library."""
    names = list(SOURCES) if names is None else list(names)
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT), tmp, out, log)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out, log) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (rc {rc}):\n{out.with_suffix('.log').read_text()[-4000:]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return seconds


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with ``argtypes``
    and ``restype`` set from ``signatures`` (function -> argtypes)."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in signatures.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        lib.pso_error_string.argtypes = [ctypes.c_int]
        lib.pso_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.pso_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc}: {msg}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
