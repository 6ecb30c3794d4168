"""The kernel build's source hash (floodplanet_code_tpu_torch/ops/cuda_build.py).

A library is named by the hash of its source, so a kernel that spans more
than one file must be rebuilt when any header it includes changes; a stale
library would otherwise be loaded. Nothing here compiles: the hash is plain
Python. A source built with ``-D`` macros (``batchnorm.cu``, one library
per type) gets one library per set of macros.
"""

import os
import subprocess
import types

from floodplanet_code_tpu_torch.ops import cuda_build


def _write(path, text):
    path.write_text(text)
    return str(path)


def test_digest_covers_every_included_header(tmp_path):
    src = _write(tmp_path / "k.cu", '#include <cuda.h>\n#include "a.cuh"\nint f();\n')
    _write(tmp_path / "a.cuh", '#pragma once\n  #  include "b.cuh"\n')
    _write(tmp_path / "b.cuh", "int g();\n")
    _write(tmp_path / "unrelated.cuh", "int h();\n")
    before = cuda_build.source_digest(src)
    assert cuda_build.source_digest(src) == before  # stable
    _write(tmp_path / "unrelated.cuh", "int h2();\n")
    assert cuda_build.source_digest(src) == before
    _write(tmp_path / "b.cuh", "int g2();\n")  # two levels down
    after = cuda_build.source_digest(src)
    assert after != before
    _write(tmp_path / "a.cuh", '#pragma once\n#include "b.cuh"\n// edited\n')
    assert cuda_build.source_digest(src) not in (before, after)


def test_digest_survives_include_cycles(tmp_path):
    src = _write(tmp_path / "k.cu", '#include "a.cuh"\n')
    _write(tmp_path / "a.cuh", '#include "b.cuh"\n')
    _write(tmp_path / "b.cuh", '#include "a.cuh"\n')
    assert len(cuda_build.source_digest(src)) == 12


def test_the_kernels_sources_hash():
    # Both kernel sources exist and hash; the library name carries the hash.
    for name in ("conv_fused", "rotate", "batchnorm"):
        assert len(cuda_build.source_digest(cuda_build.source(name))) == 12


def test_each_set_of_defines_builds_its_own_library(tmp_path, monkeypatch):
    """The macros reach nvcc as -D flags and name the library; a second
    build with the same macros finds it (no compile), other macros do not."""
    commands = []

    def nvcc(cmd, **kwargs):
        commands.append(cmd)
        with open(cmd[cmd.index("-o") + 1], "w") as handle:
            handle.write("lib")
        return types.SimpleNamespace(returncode=0, stdout="ptxas info", stderr="")

    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(subprocess, "run", nvcc)
    digest = cuda_build.source_digest(cuda_build.source("batchnorm"))
    paths = {}
    for code in (0, 2, 0):
        path, report = cuda_build.build("batchnorm", {"BNR_VEC": 1, "BNR_DTYPE": code})
        assert os.path.basename(path) == f"libbatchnorm_BNR_DTYPE{code}_BNR_VEC1_{digest}.so"
        assert report == ("" if code in paths else "ptxas info")
        paths[code] = path
    assert [[a for a in cmd if a.startswith("-D")] for cmd in commands] == [
        ["-DBNR_DTYPE=0", "-DBNR_VEC=1"], ["-DBNR_DTYPE=2", "-DBNR_VEC=1"]]
    path, _ = cuda_build.build("rotate")  # no macros: the name as before
    assert os.path.basename(path).startswith("librotate_") and "-D" not in " ".join(commands[-1])
