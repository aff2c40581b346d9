"""Build and load the port's CUDA sources (``diamond_tpu_torch/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, at first use, into ``diamond_tpu_torch/build/`` (listed
in ``.gitignore``), keyed by the hash of the source and of every shared
header (``csrc/*.cuh``), and loaded with ctypes.
Missing sources build in parallel, one ``nvcc`` per file.  A failed build
raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_libs: dict[str, ctypes.CDLL] = {}
build_log: dict[str, str] = {}  # name -> nvcc/ptxas output of its build


class NvccError(RuntimeError):
    pass


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise NvccError("nvcc not found: the CUDA toolkit is required to "
                         "build the port's kernels")


def _so_path(name: str) -> str:
    """The library of ``csrc/<name>.cu``, named by the hash of the source
    and of every ``csrc/*.cuh`` (a header edit rebuilds its includers)."""
    h = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for f in [name + ".cu"] + headers:
        h.update(f.encode() + b"\0")
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build(names) -> None:
    """Compile every named source that has no library yet, all at once."""
    todo = [n for n in names
            if n not in _libs and not os.path.exists(_so_path(n))]
    if not todo:
        return
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for n in todo:
        tmp = _so_path(n) + f".tmp{os.getpid()}"
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", tmp,
               os.path.join(CSRC_DIR, n + ".cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for n, tmp, p in procs:
        out, _ = p.communicate()
        build_log[n] = out
        if p.returncode != 0:
            failed.append(f"{n}.cu (exit {p.returncode}):\n{out}")
        else:
            os.replace(tmp, _so_path(n))
    if failed:
        raise NvccError("nvcc failed for " + "\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = ctypes.CDLL(_so_path(name))
    return lib


def check_tensors(dev, *named):
    """Each (name, tensor, dtype) lies on ``dev``, has that dtype and is
    contiguous; raises otherwise (the kernels take raw pointers)."""
    for name, x, dt in named:
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, not {dev}")
        if x.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def launcher(name: str, symbol: str, args: str):
    """The C entry point ``symbol`` of ``csrc/<name>.cu`` returning a CUDA
    error code, its arguments typed by ``args``: one letter per argument,
    ``p`` a pointer (device pointers and the stream), ``i`` an int, ``q``
    an unsigned 64-bit int."""
    types = {"p": ctypes.c_void_p, "i": ctypes.c_int, "q": ctypes.c_uint64}
    fn = getattr(library(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = [types[a] for a in args]
        fn.restype = ctypes.c_int
    return fn
