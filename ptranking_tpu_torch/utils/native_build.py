"""Build-at-first-use helper for the port's native C++ components.

The port's own copy of ptranking_tpu/utils/native_build.py. It finds a C++
compiler, rebuilds when the source is newer than the artifact, and builds
atomically (compile to a temporary path, then os.replace) under a
process-wide lock, so concurrent callers (pytest-xdist workers, threads)
never dlopen a half-written library. The port builds into `build/native/`
at the repository root (NATIVE_BUILD_DIR), never into `native/build/`,
which is the JAX package's: both packages' workers may build at once.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import threading
from typing import List, Optional

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
NATIVE_SRC_DIR = os.path.join(REPO_ROOT, "native")
NATIVE_BUILD_DIR = os.path.join(REPO_ROOT, "build", "native")

_LOCK = threading.Lock()


def _artifact_usable(out: str) -> bool:
    """Reject a stale artifact built for another platform (for example one
    restored with fresh mtimes): dlopen-probe a .so, exec-probe a binary."""
    try:
        if out.endswith(".so"):
            import ctypes

            ctypes.CDLL(out)
        else:
            subprocess.run([out], capture_output=True, timeout=10)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False


def find_cxx() -> Optional[str]:
    return (os.environ.get("CXX") or shutil.which("g++")
            or shutil.which("c++") or shutil.which("clang++"))


def build_native(src: str, out: str, extra_flags: Optional[List[str]] = None) -> Optional[str]:
    """Compile `src` to `out` if missing or stale; returns `out`, or None when
    the source or a compiler is missing. Raises on a compile error."""
    if not os.path.exists(src):
        return None
    with _LOCK:
        if (os.path.exists(out)
                and os.path.getmtime(out) >= os.path.getmtime(src) and _artifact_usable(out)):
            return out
        cxx = find_cxx()
        if cxx is None:
            return None
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.tmp.{os.getpid()}.{threading.get_ident()}"
        cmd = [cxx, "-O3", "-std=c++17", *(extra_flags or []), "-o", tmp, src]
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp, out)  # atomic on POSIX
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return out
