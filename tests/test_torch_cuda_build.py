"""The kernel build's source hash (floodplanet_code_tpu_torch/ops/cuda_build.py).

A library is named by the hash of its source, so a kernel that spans more
than one file must be rebuilt when any header it includes changes; a stale
library would otherwise be loaded. Nothing here compiles: the hash is plain
Python.
"""

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
    for name in ("conv_fused", "rotate"):
        assert len(cuda_build.source_digest(cuda_build.source(name))) == 12
