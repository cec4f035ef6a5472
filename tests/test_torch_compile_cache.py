"""utils/compile_cache.py, the port's counterpart of the JAX package's
persistent compilation cache, without nvcc: where the kernels' libraries go
(ops/cuda_build.py's BUILD_DIR) by default, under PTRANKING_COMPILE_CACHE_DIR
and under PTRANKING_COMPILE_CACHE=0, and that `ltr.main` asks for it as the
JAX CLI does."""

import os

import pytest

from ptranking_tpu_torch import ltr
from ptranking_tpu_torch.ops import cuda_build
from ptranking_tpu_torch.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _restore_build_dir(monkeypatch):
    """Each test leaves cuda_build's library directory as it found it."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.delenv("PTRANKING_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("PTRANKING_COMPILE_CACHE_DIR", raising=False)


def test_default_directory_is_build_kernels():
    """The default is `build/kernels/` at the repository root, where
    `python3 chip_smoke.py` builds (and .gitignore lists `build/`); `=1`,
    the JAX package's "force on a CPU backend", means what unset means."""
    want = os.path.join(REPO, "build", "kernels")
    assert str(compile_cache.DEFAULT_DIR) == want
    assert compile_cache.enable_persistent_cache() == want
    assert str(cuda_build.BUILD_DIR) == want
    assert str(cuda_build.library_path("sinkstep").parent) == want
    os.environ["PTRANKING_COMPILE_CACHE"] = "1"
    assert compile_cache.enable_persistent_cache() == want
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert "build/" in f.read().split()


def test_cache_dir_variable_redirects_the_libraries(tmp_path, monkeypatch):
    """PTRANKING_COMPILE_CACHE_DIR (or an explicit path) is where
    cuda_build names, and would build, every kernel's library."""
    monkeypatch.setenv("PTRANKING_COMPILE_CACHE_DIR", str(tmp_path / "cache"))
    assert compile_cache.enable_persistent_cache() == str(tmp_path / "cache")
    for name in cuda_build.all_kernels():
        assert cuda_build.library_path(name).parent == tmp_path / "cache"
    assert compile_cache.enable_persistent_cache(str(tmp_path / "x")) == str(tmp_path / "x")
    assert cuda_build.BUILD_DIR == tmp_path / "x"


def test_cache_off_builds_into_a_directory_of_its_own(monkeypatch):
    """PTRANKING_COMPILE_CACHE=0 returns None and points the libraries at a
    fresh directory of the process's own: a second call gets another one,
    and neither is the persistent cache."""
    monkeypatch.setenv("PTRANKING_COMPILE_CACHE", "0")
    monkeypatch.setenv("PTRANKING_COMPILE_CACHE_DIR", "/nonexistent/cache")
    assert compile_cache.enable_persistent_cache() is None
    first = cuda_build.BUILD_DIR
    assert first.is_dir() and not any(first.iterdir())
    assert compile_cache.enable_persistent_cache() is None
    second = cuda_build.BUILD_DIR
    assert second != first and second.is_dir()
    for d in (first, second):
        assert d != compile_cache.DEFAULT_DIR and str(d) != "/nonexistent/cache"
        assert cuda_build.library_path("sinkstep").parent == second


def test_ltr_main_enables_the_cache(tmp_path, monkeypatch):
    """`ltr.main` calls enable_persistent_cache before it runs, as the JAX
    CLI does (ptranking_tpu/ltr.py): a debug run on the CPU
    names its libraries under PTRANKING_COMPILE_CACHE_DIR."""
    calls = []
    real = compile_cache.enable_persistent_cache
    monkeypatch.setattr(ltr, "enable_persistent_cache",
                        lambda *a: calls.append(real(*a)) or calls[-1])
    monkeypatch.setenv("PTRANKING_COMPILE_CACHE_DIR", str(tmp_path / "cache"))
    ltr.main(["-device", "cpu", "-model", "RankMSE", "-debug", "-epochs", "1",
              "-dir_output", str(tmp_path / "out")])
    assert calls == [str(tmp_path / "cache")]
    assert cuda_build.BUILD_DIR == tmp_path / "cache"
