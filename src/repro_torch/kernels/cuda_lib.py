"""Build, load and count launches of the port's CUDA kernels.

The kernels in `repro_torch/csrc/*.cu` have a plain C interface.  At first
use `library()` compiles each source with its own `nvcc` process (all
started together) for ``sm_90a``, links them into one shared library under
``build/repro_torch/`` at the repo root, and loads it with `ctypes`.  The
file name carries a hash of the sources and flags, so a stale build is
never loaded.  Nothing is built or loaded at import time.

`LAUNCHES` counts kernel launches per wrapper; a wrapper adds one right
where it launches and nowhere else.

A wrapper also reports each call to the step counter active in its
thread (`dist.hlo_analysis.StepCounter`), if any, through `count_kernel`:
one op with the kernel's work, on the card or on ``meta`` tensors, where
it allocates the outputs and launches nothing.  Without a counter this is
one thread-local read a call.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {"window_filter": 0, "window_match": 0, "sfc_encode": 0,
            "sfc_encode_pool": 0, "split_zranges": 0, "flash_attention": 0,
            "flash_attention_tc": 0}

_VP, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_I64P = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    # points, page_size, queries, cand, n_cand, out, P, Qc, C, d, cap, stream
    "window_filter_launch": (_VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT, _INT,
                             _INT, _INT, _VP),
    # d, cap -> dynamic shared memory bytes of a window_filter block
    "window_filter_smem_bytes": (_INT, _INT),
    # points, page_size, queries, cand, n_cand, counts, bits, mask, P, Qc,
    # C, d, cap, stream
    "window_match_launch": (_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _INT,
                            _INT, _INT, _INT, _INT, _VP),
    # counts, bits, cand, n_cand, ids, n_hits, Qc, C, cap, max_hits, stream
    "window_match_ids_launch": (_VP, _VP, _VP, _VP, _VP, _VP, _INT, _INT,
                                _INT, _INT, _VP),
    # x, lut, reg, out, n, d, K, R, M, staged, blocks, stream
    "sfc_encode_launch": (_VP, _VP, _VP, _VP, _I64, _INT, _INT, _INT, _INT,
                          _INT, _INT, _VP),
    # x, x_stride, lut, reg, out, n, d, K, R, M, P, staged, blocks, stream
    "sfc_encode_pool_launch": (_VP, _I64, _VP, _VP, _VP, _I64, _INT, _INT,
                               _INT, _INT, _INT, _INT, _INT, _VP),
    # queries, lut, reg, valid, zlo, zhi, Q, d, K, R, M, k, staged, blocks,
    # stream
    "split_zranges_launch": (_VP, _VP, _VP, _VP, _VP, _VP, _I64, _INT, _INT,
                             _INT, _INT, _INT, _INT, _INT, _VP),
    # q, k, v, o, BH, BKH, S, dh, causal, window, stream (float32)
    "flash_attention_launch": (_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT,
                               _INT, _INT, _VP),
    # dh -> dynamic shared memory bytes of a float32 block
    "flash_attention_smem_bytes": (_INT,),
    # q, k, v, o, 12 strides, B, H, KH, S, dh, causal, window, stream (bf16)
    "flash_attention_tc_launch": (_VP, _VP, _VP, _VP, _I64P, _INT, _INT,
                                  _INT, _INT, _INT, _INT, _INT, _VP),
}

_counter = threading.local()   # .active: the thread's step counter

_lib = None
_lib_lock = threading.Lock()   # one build and bind a process, whichever
                               # thread (a serving drain thread) comes first


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def set_step_counter(counter):
    """Make `counter` this thread's active step counter (None: none);
    returns the one it replaces."""
    prev = getattr(_counter, "active", None)
    _counter.active = counter
    return prev


def count_kernel(key: str, work) -> None:
    """Report one call of kernel `key` to the active step counter, if any:
    `work()` gives its (flops, bytes, input shapes, outputs)."""
    counter = getattr(_counter, "active", None)
    if counter is not None:
        with counter.quiet():
            flops, nbytes, shapes, out = work()
        counter.record_kernel(key, flops, nbytes, shapes, out)


def uncounted():
    """A context in which the active step counter, if any, records no op:
    a wrapper's own bookkeeping (its cached tables) is part of its one
    counted call."""
    counter = getattr(_counter, "active", None)
    return counter.quiet() if counter is not None else \
        contextlib.nullcontext()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built "
                           "from source on a machine with the CUDA toolkit")
    return nvcc


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile and link the kernels unless the hashed library exists.
    Returns its path; the compiler's log (``-Xptxas -v``: registers,
    shared memory, spills) is written beside it as ``.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_DIR))
    try:
        procs = []
        for src in _sources():
            obj = tmp / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, objs = [], []
        for src, obj, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
            objs.append(str(obj))
        so = tmp / lib.name
        link = subprocess.run(
            [nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", str(so), *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        lib.with_suffix(".log").write_text("\n".join(log))
        os.replace(so, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, under a lock, so
    that threads launching at once build and bind it once)."""
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                lib = ctypes.CDLL(str(build()))
                for name, argtypes in _SIGNATURES.items():
                    fn = getattr(lib, name)
                    fn.argtypes = list(argtypes)
                    fn.restype = ctypes.c_int
                _lib = lib
    return _lib


def launch(name: str, *args) -> None:
    """Call C entry point `name` on the current stream; raise on a CUDA
    error reported by the launch (``cudaGetLastError``)."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def check_cuda_int32(name: str, t: torch.Tensor, ndim: int) -> None:
    """Raise unless `t` is a contiguous int32 CUDA tensor of rank `ndim`."""
    check_cuda(name, t, torch.int32, ndim)


def on_card(t: torch.Tensor) -> bool:
    """Whether a wrapper launches for `t`: a CUDA tensor.  The other
    device its kernel route takes is ``meta`` (shapes alone: outputs
    allocated, nothing launched)."""
    return t.device.type == "cuda"


def check_cuda(name: str, t: torch.Tensor, dtype, ndim: int) -> None:
    """Raise unless `t` is a contiguous `dtype` CUDA (or meta) tensor of
    rank `ndim`."""
    if t.device.type not in ("cuda", "meta"):
        raise ValueError(f"{name} must be a CUDA tensor; got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}; got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have rank {ndim}; got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
