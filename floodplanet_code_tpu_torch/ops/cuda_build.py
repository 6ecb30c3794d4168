"""Build and load the port's CUDA kernels: ``csrc/<name>.cu`` -> ``_build/``.

Every kernel source has a plain C interface and is compiled by ``nvcc`` for
``sm_90a`` into a shared library named by the source's hash, then loaded
with ``ctypes`` (seconds per build; ``torch.utils.cpp_extension.load``
would compile PyTorch's headers, which takes minutes). Nothing is built or
loaded when a module is imported: the first launch on a card does it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Callable

import torch

CSRC = os.path.join(os.path.dirname(__file__), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_prepared: set[tuple[str, int]] = set()  # (library, device) after its prepare call


def source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                           "the kernels under " + CSRC)
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def source_digest(src: str) -> str:
    """Hash of ``src`` and, recursively, of every header it includes with
    quotes (``#include "x.cuh"``, resolved next to the including file), so a
    change to any of them builds a new library."""
    digest = hashlib.sha1()
    seen: set[str] = set()
    todo = [os.path.abspath(src)]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        with open(path, "rb") as handle:
            text = handle.read()
        digest.update(os.path.basename(path).encode() + b"\0" + text)
        todo.extend(os.path.join(os.path.dirname(path), inc.decode())
                    for inc in _INCLUDE.findall(text))
    return digest.hexdigest()[:12]


def build(name: str) -> tuple[str, str]:
    """Compile ``csrc/<name>.cu`` for ``sm_90a`` unless this source version
    (``source_digest``: the file and the headers it includes) is already
    built. Returns (library path, compiler report); the report (``ptxas
    -v``: registers, shared memory, spills) is empty when the library was
    already there."""
    src = source(name)
    digest = source_digest(src)
    lib_path = os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")
    if os.path.exists(lib_path):
        return lib_path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [
        _nvcc(),
        "-gencode=arch=compute_90a,code=sm_90a",
        "-std=c++17",
        "-O3",
        "-Xptxas=-v",
        "-shared",
        "-Xcompiler",
        "-fPIC",
        "-o",
        tmp,
        src,
    ]
    result = subprocess.run(cmd, capture_output=True, text=True)
    if result.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {src}:\n{result.stdout}\n{result.stderr}"
        )
    os.replace(tmp, lib_path)  # atomic: a concurrent build never sees a half file
    return lib_path, result.stdout + result.stderr


def load(
    name: str,
    prefix: str,
    declare: Callable[[ctypes.CDLL], None],
    device: torch.device,
    prepare: bool = False,
) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu``, built and loaded once per process.

    Its C functions carry ``prefix``: ``<prefix>_cuda_error_string(int)``
    names a CUDA error code, and with ``prepare`` an ``int
    <prefix>_prepare(void)`` runs once per device before the first launch
    there. ``declare`` sets the other functions' argument and result types.
    """
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name)[0])
            errstr = getattr(lib, f"{prefix}_cuda_error_string")
            errstr.restype = ctypes.c_char_p
            errstr.argtypes = [ctypes.c_int]
            declare(lib)
            _libs[name] = lib
        if prepare and (name, device.index) not in _prepared:
            with torch.cuda.device(device):
                err = getattr(lib, f"{prefix}_prepare")()
            if err != 0:
                raise RuntimeError(
                    f"{name}: preparing {device} failed: "
                    f"{error_string(lib, prefix, err)}"
                )
            _prepared.add((name, device.index))
        return lib


def error_string(lib: ctypes.CDLL, prefix: str, err: int) -> str:
    return getattr(lib, f"{prefix}_cuda_error_string")(err).decode()
