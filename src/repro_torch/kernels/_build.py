"""Build and load the port's CUDA kernels: ``nvcc`` into one shared library.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` by its own ``nvcc``
process (all started together), linked into ``build/repro_torch/
libkernels.so`` at the root of the checkout, and loaded with ``ctypes``. The
sources (``*.cu`` and the ``*.cuh`` headers they include) are the only
inputs; the build runs at first use and is skipped when a library built from
the same sources and flags is already there. No fast
math: δ feeds accept decisions.

Each C entry point takes device pointers (``tensor.data_ptr()``) and the
current stream, launches on that stream, and returns ``cudaGetLastError()``;
:func:`check` turns a nonzero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lib = None
build_seconds: float | None = None  # wall time of the last build (None: cached)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link the library."""
    global build_seconds
    sources = sorted(CSRC.glob("*.cu"))
    so = BUILD_DIR / "libkernels.so"
    stamp = BUILD_DIR / "libkernels.sha256"
    digest = _digest(sources + sorted(CSRC.glob("*.cuh")))
    if so.exists() and stamp.exists() and stamp.read_text() == digest:
        build_seconds = None
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for src in sources:
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(src.name)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    link = [nvcc, "-shared", "-o", str(so), *(str(o) for _, o, _ in procs)]
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"linking {so.name} failed:\n{res.stdout}{res.stderr}")
    stamp.write_text(digest)
    build_seconds = time.perf_counter() - t0
    return so


def _declare(lib) -> None:
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.bright_glm_launch.argtypes = [
        p, p, p, p, i64, p, p, p, p, p,  # x t xi idx idx_stride nb θ δ part tot
        p, i, i, i, i, i, i,  # arrivals K C N D kt family
        f, f, f,  # nu sigma h
        i, i64, i64, i64, i64, p,  # L x_lane t_lane xi_lane idx_lane stream
    ]
    lib.bright_glm_launch.restype = i
    lib.bright_glm_wide_launch.argtypes = [
        p, p, p, p, i64, p, p, p, p, p,  # x t xi idx idx_stride nb θ δ part tot
        p, p, p, i, i, i, i, i,  # stats arrivals tile_arrivals K C N D kt
        i, i64, i64, i64, i64, p,  # L x_lane t_lane xi_lane idx_lane stream
    ]
    lib.bright_glm_wide_launch.restype = i
    lib.z_candidates_launch.argtypes = [
        p, i64, i64, p, p, p, p,  # arr arr_stride arr_lane num kw cand count
        p, p, i64,  # ctl status status_stride
        i, i, i, i, i, p,  # K L N q_bits cap stream
    ]
    lib.z_candidates_launch.restype = i
    ll = ctypes.c_longlong
    lib.decode_attention_launch.argtypes = [
        p, p, p, p, p, p, p, p,  # q k v pos part out m l
        i, i, i, i, i, i, i,  # B Hk G D W split_len n_split
        ll, ll, i, i, p,  # t window has_window kv_bf16 stream
    ]
    lib.decode_attention_launch.restype = i
    lib.rglru_scan_launch.argtypes = [
        p, p, p, p, p,  # log_a bx h0 (or null) y h_last
        i, i, i, p,  # B S C stream
    ]
    lib.rglru_scan_launch.restype = i
    lib.rglru_scan_bwd_launch.argtypes = [
        p, p, p, p, p,  # log_a g_h h h0 (or null) g_last (or null)
        p, p, p,  # d_log_a (or null) d_bx d_h0 (or null)
        i, i, i, p,  # B S C stream
    ]
    lib.rglru_scan_bwd_launch.restype = i
    lib.rwkv6_scan_launch.argtypes = [
        p, p, p, p, p, p,  # r k v logw u state0 (or null)
        p, p, p,  # y state states (or null)
        i, i, i, i, i, p,  # B H S D c stream
    ]
    lib.rwkv6_scan_launch.restype = i
    lib.rwkv6_scan_bwd_launch.argtypes = [
        p, p, p, p, p, p, p, p,  # r k v logw u states dy d_state (or null)
        p, p, p, p, p, p,  # dr dk dv dlogw du dstate0 (or null)
        p, p, p,  # ds du_part rows (scratch)
        i, i, i, i, i, p,  # B H S D c stream
    ]
    lib.rwkv6_scan_bwd_launch.restype = i
    lib.fused_ce_launch.argtypes = [
        p, p, p, p, p, p,  # x w labels part lse tgt
        i, i, i, i, i, p,  # T D V is_bf16 round_logits stream
    ]
    lib.fused_ce_launch.restype = i
    lib.kernels_error_string.argtypes = [i]
    lib.kernels_error_string.restype = ctypes.c_char_p


def library():
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        _declare(lib)
        _lib = lib
    return _lib


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        text = library().kernels_error_string(code).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {code} "
                           f"({text})")


def describe(**tensors) -> str:
    """Device, shape, dtype and strides of each operand, for an error."""
    return "; ".join(f"{name} {tuple(a.shape)} {a.dtype} on {a.device}, "
                     f"strides {a.stride()}" for name, a in tensors.items())


def stream_ptr(device) -> int:
    """The raw ``cudaStream_t`` of ``device``'s current stream (without
    building a ``torch.cuda.Stream`` object)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device.index)
