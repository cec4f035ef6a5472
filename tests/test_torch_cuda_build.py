"""The kernel builder's library names (CPU only: nothing is compiled).

A library's file name carries a hash of its source, of the headers the source
includes and of the flags, so that an edited header rebuilds every library
that includes it and a stale library is never loaded.
"""

import pytest

from ptranking_tpu_torch.ops import cuda_build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A kernel source tree: a.cu includes common.cuh, which includes
    inner.cuh from a subdirectory; b.cu includes nothing."""
    (tmp_path / "sub").mkdir()
    (tmp_path / "a.cu").write_text('#include <stdint.h>\n#include "common.cuh"\nint a;\n')
    (tmp_path / "common.cuh").write_text('#pragma once\n  #  include "sub/inner.cuh"\nint c;\n')
    (tmp_path / "sub" / "inner.cuh").write_text("int i;\n")
    (tmp_path / "other.cuh").write_text("int o;\n")
    (tmp_path / "b.cu").write_text("// #include \"other.cuh\" is a comment\nint b;\n")
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_source_files_follow_quoted_includes(csrc):
    assert cuda_build.source_files(csrc / "a.cu") == [
        (csrc / "a.cu").resolve(), (csrc / "common.cuh").resolve(),
        (csrc / "sub" / "inner.cuh").resolve()]
    assert cuda_build.source_files(csrc / "b.cu") == [(csrc / "b.cu").resolve()]


@pytest.mark.parametrize("edited", ["a.cu", "common.cuh", "sub/inner.cuh"])
def test_library_path_changes_with_the_source_and_its_headers(csrc, edited):
    before_a, before_b = cuda_build.library_path("a"), cuda_build.library_path("b")
    path = csrc / edited
    path.write_text(path.read_text() + "int edited;\n")
    assert cuda_build.library_path("a") != before_a
    assert cuda_build.library_path("b") == before_b


def test_library_path_ignores_headers_not_included(csrc):
    before = cuda_build.library_path("a"), cuda_build.library_path("b")
    (csrc / "other.cuh").write_text("int edited;\n")
    assert (cuda_build.library_path("a"), cuda_build.library_path("b")) == before


def test_missing_include_raises(csrc):
    (csrc / "a.cu").write_text('#include "gone.cuh"\n')
    with pytest.raises(FileNotFoundError, match="gone.cuh"):
        cuda_build.library_path("a")


def test_attention_libraries_hash_the_shared_header():
    """Both attention kernels include csrc/mma_common.cuh; the other kernels
    are self-contained."""
    header = (cuda_build.CSRC / "mma_common.cuh").resolve()
    for name in cuda_build.all_kernels():
        files = cuda_build.source_files(cuda_build.CSRC / f"{name}.cu")
        assert (header in files) == name.startswith("flash_attn_"), name
