"""Build and load the port's CUDA kernels.

The sources in ``repro_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, loaded with
``ctypes``.  The build runs at first use (never at import: the CPU tests
import every module on a machine with no ``nvcc``), into
``build/kernels/<hash>/`` at the repository root, keyed by a hash of the
sources and flags, so an edited kernel is rebuilt and an unchanged one is
loaded.  Each ``.cu`` file compiles in its own ``nvcc`` process, all
started together, and the objects are linked into one ``.so``.

Every C entry returns ``cudaGetLastError()`` after its launch; ``check``
turns a non-zero code into an exception, since a refused launch never runs
and ``torch.cuda.synchronize()`` would not report it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("rmsnorm.cu", "rmsnorm_bwd.cu", "decode_attention.cu",
           "flash_append.cu", "flash_attention.cu", "flash_attention_bwd.cu",
           "rmsprop.cu")
HEADERS = ("common.cuh", "attention_tiles.cuh", "mma_tiles.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# dtype codes of the C interface (csrc/common.cuh, rt::DType): activations
# are f32 or bf16; a KV cache may also be int8 (with f32 row scales)
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
KV_DTYPE_CODE = {**DTYPE_CODE, torch.int8: 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "rt_rmsnorm_fwd": (_P, _P, _P, _P, _L, _I, _F, _I, _P),
    "rt_rmsnorm_bwd": (_P, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P),
    "rt_decode_attention_fwd": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _I, _I, _P),
    "rt_decode_attention_partials": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _I, _I, _P),
    "rt_flash_append_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _I, _I, _I, _I, _P),
    "rt_flash_attention_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, _P),
    "rt_flash_attention_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "rt_rmsprop_update": (_P, _P, _P, _P, _L, _F, _F, _F, _F, _P),
}

_lib: Optional[ctypes.CDLL] = None
build_log = ""          # ptxas register / shared-memory report of the build
build_seconds = 0.0     # 0.0 when the library was already built


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH): the port's CUDA "
                       "kernels are built on the machine with the card")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / source_hash() / "librepro_torch_kernels.so"


def build() -> Path:
    """Compile the sources into the shared library unless the library for
    this source hash exists.  Returns its path."""
    global build_log, build_seconds
    out = library_path()
    if out.exists():
        return out
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        procs = []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c",
                   str(CSRC / name), "-o", obj]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for name, _, p in procs:
            text, _ = p.communicate()
            logs.append(f"== {name}\n{text}")
            if p.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_so = os.path.join(tmp, out.name)
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", tmp_so, *[obj for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, out)
    build_log = "\n".join(logs)
    build_seconds = time.perf_counter() - t0
    return out


def _kernel_name(mangled: str) -> str:
    """The ``*_kernel`` identifier in a mangled name (a length-prefixed
    source name; the length is the tail of a run of digits, since a
    file-hash prefix may end in digits), with its first int template
    argument (the head dim)."""
    for run in re.finditer(r"\d+", mangled):
        digits = run.group()
        for i in range(len(digits)):
            n, at = int(digits[i:]), run.end()
            ident = mangled[at:at + n]
            if len(ident) == n and ident.endswith("_kernel") and \
                    re.fullmatch(r"[A-Za-z_]\w*", ident):
                arg = re.match(r"ILi(\d+)E", mangled[at + n:])
                return ident + (f"<{arg.group(1)}>" if arg else "")
    return mangled


def kernel_resources(log: str) -> list:
    """Per kernel of a ``-Xptxas=-v`` build log: its name (with the head
    dim it was instantiated for), registers, spill stores and loads and
    stack frame, in bytes."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"name": _kernel_name(m.group(1))}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc} "
                           f"({torch.cuda.get_device_name()})")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(cond: bool, what: str, msg: str) -> None:
    """Input validation shared by the wrappers: raise, never fall back."""
    if not cond:
        raise ValueError(f"{what}: {msg}")
