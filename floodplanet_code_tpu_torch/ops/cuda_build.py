"""Build and load the port's CUDA kernels: ``csrc/<name>.cu`` -> ``_build/``.

Every kernel source has a plain C interface and is compiled by ``nvcc`` for
``sm_90a`` into a shared library named by the source's hash, then loaded
with ``ctypes`` (seconds per build; ``torch.utils.cpp_extension.load``
would compile PyTorch's headers, which takes minutes). Nothing is built or
loaded when a module is imported: the first launch on a card does it.
"""

from __future__ import annotations

import ctypes
import functools
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


def _tag(defines: dict[str, int] | None) -> str:
    """The part of a library's name that its ``-D`` macros make."""
    return "".join(f"_{k}{v}" for k, v in sorted((defines or {}).items()))


def build(name: str, defines: dict[str, int] | None = None) -> tuple[str, str]:
    """Compile ``csrc/<name>.cu`` for ``sm_90a`` unless this source version
    (``source_digest``: the file and the headers it includes) is already
    built with these ``defines`` (``-D<key>=<value>``: one library each).
    Returns (library path, compiler report); the report (``ptxas -v``:
    registers, shared memory, spills) is empty when the library was already
    there."""
    src = source(name)
    digest = source_digest(src)
    lib_path = os.path.join(BUILD_DIR, f"lib{name}{_tag(defines)}_{digest}.so")
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
        *(f"-D{k}={v}" for k, v in sorted((defines or {}).items())),
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
    defines: dict[str, int] | None = None,
) -> ctypes.CDLL:
    """The library of ``csrc/<name>.cu`` with ``defines`` (``build``), built
    and loaded once per process.

    Its C functions carry ``prefix``: ``<prefix>_cuda_error_string(int)``
    names a CUDA error code, and with ``prepare`` an ``int
    <prefix>_prepare(void)`` runs once per device before the first launch
    there. ``declare`` sets the other functions' argument and result types.
    """
    key = name + _tag(defines)
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            lib = ctypes.CDLL(build(name, defines)[0])
            errstr = getattr(lib, f"{prefix}_cuda_error_string")
            errstr.restype = ctypes.c_char_p
            errstr.argtypes = [ctypes.c_int]
            declare(lib)
            _libs[key] = lib
        if prepare and (key, device.index) not in _prepared:
            with torch.cuda.device(device):
                err = getattr(lib, f"{prefix}_prepare")()
            if err != 0:
                raise RuntimeError(
                    f"{name}: preparing {device} failed: "
                    f"{error_string(lib, prefix, err)}"
                )
            _prepared.add((key, device.index))
        return lib


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The card's streaming multiprocessors, which the kernels' grids fill."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def error_string(lib: ctypes.CDLL, prefix: str, err: int) -> str:
    return getattr(lib, f"{prefix}_cuda_error_string")(err).decode()
