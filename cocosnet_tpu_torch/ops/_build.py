"""Builds the hand-written CUDA kernels and loads them with ctypes.

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into its own shared
library with a plain C interface, under `build/kernels/` at the repository
root, named by a hash of the source and of the headers it includes (`#include
"..."`, followed recursively), so an edited source or header rebuilds. A build
happens at the first use of a kernel, or for all of them at once through
`build_all()` (one `nvcc` process per source, started together). Nothing
here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build",
                         "kernels")
SOURCES = ("shift9_fwd", "shift9_bwd", "conv3x3", "conv3x3_onehot",
           "corr_fwd", "corr_bwd", "conv3x3_dw", "stage_mark",
           "reflect_ring")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of every exported launcher: name -> argtypes (all return int)
SIGNATURES = {
    "shift9_fwd": {
        "cocosnet_shift9_fwd": [_P] * 9 + [_I] * 7 + [_P],
        "cocosnet_shift9_max_d": [],
        "cocosnet_shift9_fwd_blocks": [_I] * 3,
        "cocosnet_shift9_fwd_key_regions": [_I],
    },
    "shift9_bwd": {
        "cocosnet_shift9_bwd": [_P] * 17 + [_I] * 6 + [_P],
        "cocosnet_shift9_bwd_tile": [],
        "cocosnet_shift9_bwd_owned": [],
    },
    "conv3x3": {
        "cocosnet_conv3x3": [_P] * 7 + [_I] * 7 + [_F] + [_I] * 5 + [_P],
        "cocosnet_conv3x3_tile_pixels": [],
    },
    "conv3x3_onehot": {
        "cocosnet_conv3x3_onehot": [_P] * 6 + [_I] * 6 + [_F, _I, _I, _P],
        "cocosnet_onehot_blocks": [_I] * 7,
    },
    "corr_fwd": {
        "cocosnet_corr_fwd": [_P] * 5 + [_I] * 5 + [_F, _P],
        "cocosnet_corr_max_d": [],
    },
    "corr_bwd": {
        "cocosnet_corr_bwd": [_P] * 11 + [_I] * 5 + [_F, _P],
        "cocosnet_corr_bwd_tile": [],
    },
    "conv3x3_dw": {
        "cocosnet_conv3x3_dw": [_P] * 7 + [_I] * 8 + [_P],
        "cocosnet_conv3x3_dw_splits": [_I] * 6,
    },
    "stage_mark": {
        "cocosnet_stage_mark": [_I, _P],
    },
    "reflect_ring": {
        "cocosnet_reflect_ring_fwd": [_P] * 2 + [_I] * 7 + [_P],
        "cocosnet_reflect_ring_bwd": [_P] * 2 + [_I] * 7 + [_P],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def _source_bytes(name: str) -> bytes:
    """csrc/<name>.cu followed by every header it includes with quotes,
    recursively, each once, in the order they are first met."""
    seen, parts = set(), []

    def visit(path):
        path = os.path.normpath(path)
        if path in seen:
            return
        seen.add(path)
        with open(path, "rb") as f:
            data = f.read()
        parts.append(data)
        for inc in _INCLUDE.findall(data):
            visit(os.path.join(os.path.dirname(path), inc.decode()))

    visit(os.path.join(CSRC, name + ".cu"))
    return b"".join(parts)


def _target(name: str) -> str:
    digest = hashlib.sha1(_source_bytes(name) + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:12]}.so")


def _compile_cmd(name: str, out: str):
    return [nvcc(), *NVCC_FLAGS, "-o", out, os.path.join(CSRC, name + ".cu")]


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Compiles every source whose library is missing, all in parallel, and
    raises with the compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in names:
        out = _target(name)
        if os.path.exists(out):
            continue
        # a name of this process's own, then an atomic rename: processes
        # that build the same library at once (the workers of one run) do
        # not write one file
        tmp = f"{out}.{os.getpid()}.tmp"
        procs.append((name, out, tmp, subprocess.Popen(
            _compile_cmd(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(_target(name))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
