"""Build the port's CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each source in ``csrc/`` is compiled on its own, all at once, into a shared
library with a plain C interface (``nvcc -gencode arch=compute_90a,
code=sm_90a -O3 -shared -Xcompiler -fPIC``), written under ``BUILD_DIR`` (a
directory ``.gitignore`` lists) and loaded with ``ctypes``. Libraries are
named by a digest of their sources and flags, so an edited source is never
served from a stale build. The build runs once per process, under a lock:
the first launch may come from a scheduler worker thread, though the
serving engine builds on its constructor's thread. A failed build raises
with the compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

# library name -> its translation unit; every .cu also includes HEADERS
SOURCES = {"flash_attention": "flash_attention.cu",
           "chunk_attention": "chunk_attention.cu"}
HEADERS = ("attention_tile.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# the one C signature of every launcher (AIOS_LAUNCHER_PARAMS in the header)
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LAUNCHER_ARGTYPES = ([_P] * 7 + [_I] * 8 + [_L] * 12 +
                     [ctypes.c_float, _I, _I, _P])
LAUNCHERS = {"flash_attention": ("aios_flash_attention",),
             "chunk_attention": ("aios_chunk_attention",
                                 "aios_packed_chunk_attention")}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_seconds = 0.0      # wall time of this process's build (0 until built)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")


def _digest(source: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in (source,) + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(SOURCES[name])}.so"


def ensure_built() -> Dict[str, ctypes.CDLL]:
    """Compile (in parallel, one nvcc per source) whatever is not built yet,
    load every library and declare its launchers. Idempotent."""
    global build_seconds
    with _lock:
        if _libs:
            return _libs
        t0 = time.perf_counter()
        nvcc = nvcc_path()
        if not os.path.exists(nvcc):
            raise RuntimeError(
                f"nvcc not found (looked on PATH and at {nvcc}); the CUDA "
                "kernels of repro_torch are built from csrc/ at first use")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for name, src in SOURCES.items():
            out = library_path(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
            procs.append((name, out, tmp, cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
        failures = []
        for name, out, tmp, cmd, p in procs:
            log = p.communicate()[0].decode(errors="replace")
            if p.returncode != 0:
                failures.append(f"$ {' '.join(cmd)}\n{log}")
                continue
            os.replace(tmp, out)
        if failures:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
        libs = {}
        for name in SOURCES:
            lib = ctypes.CDLL(str(library_path(name)))
            for fn in LAUNCHERS[name]:
                f = getattr(lib, fn)
                f.argtypes = LAUNCHER_ARGTYPES
                f.restype = ctypes.c_int
            libs[name] = lib
        _libs.update(libs)
        build_seconds = time.perf_counter() - t0
        return _libs


def launcher(library: str, fn: str):
    return getattr(ensure_built()[library], fn)


# -- launching ------------------------------------------------------------------
# query rows a block computes (ROWS in csrc/attention_tile.cuh): a block holds
# ROWS // G query positions for the G heads that share one kv head
ROWS = 64
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check_index(name: str, t, n: int, device) -> None:
    if t.dtype != torch.int32 or t.device != device or tuple(t.shape) != (n,) \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous int32 [{n}] tensor on "
                         f"{device}; got {t.dtype} {tuple(t.shape)} on {t.device}")


def launch_attention(library: str, fn: str, q, k, v, out, index, *, B: int,
                     Sq: int, window: int, packed: bool = False) -> None:
    """Validate what the kernels take and launch ``fn`` on the current
    stream. q and out are [B, Sq, H, hd], or [Sq, H, hd] when ``packed``;
    k, v [B, S, K, hd]; ``index`` is the kernel's int32 [B] tensors (2 or 3
    of them). Strides are passed as they are (no copies). Raises on
    anything else."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: the CUDA kernel takes CUDA tensors, got {dev}")
    for name, t in (("k", k), ("v", v), ("out", out)):
        if t.device != dev:
            raise ValueError(f"{fn}: {name} is on {t.device}, q on {dev}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype \
            or out.dtype != q.dtype:
        raise ValueError(f"{fn}: q/k/v must share float32 or bfloat16, got "
                         f"{q.dtype}/{k.dtype}/{v.dtype}")
    q_dims = 3 if packed else 4
    if q.dim() != q_dims or k.dim() != 4 or tuple(out.shape) != tuple(q.shape) \
            or q.shape[-3] != Sq or (q_dims == 4 and q.shape[0] != B):
        raise ValueError(f"{fn}: need q of {q_dims} dims ({Sq} positions, "
                         f"batch {B}), 4-dim k/v and out shaped as q; got q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} out "
                         f"{tuple(out.shape)}")
    hd = q.shape[-1]
    _, S, K, khd = k.shape
    H = q.shape[-2]
    if hd not in HEAD_DIMS or khd != hd or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{fn}: head_dim must be one of {HEAD_DIMS} and match "
                         f"k/v; got q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if k.shape[0] != B or H % K or H // K > ROWS:
        raise ValueError(f"{fn}: need k batch {B}, H % K == 0 and "
                         f"H // K <= {ROWS}; got H={H} K={K} k {tuple(k.shape)}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(-1) != 1 or t.data_ptr() % 16 or any(
                s % vec for s in t.stride()[:-1] if t.dim() > 1):
            raise ValueError(f"{fn}: {name} needs a unit last stride, a 16-byte "
                             f"aligned base and strides in multiples of {vec} "
                             f"elements; got strides {t.stride()}")
    for i, t in enumerate(index):
        _check_index(f"{fn} index {i}", t, B, dev)
    a2 = index[2].data_ptr() if len(index) > 2 else None
    G = H // K
    # (batch, position, head) strides in elements; batch 0 on the packed axis
    q_strides = ((0,) if packed else ()) + q.stride()[:-1]
    o_strides = ((0,) if packed else ()) + out.stride()[:-1]
    rc = launcher(library, fn)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        index[0].data_ptr(), index[1].data_ptr(), a2,
        B, Sq, H, K, S, int(window), G, ROWS // G,
        *q_strides, k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), *o_strides,
        1.0 / math.sqrt(hd), _DTYPE_CODE[q.dtype], hd,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed with CUDA error {rc}")
