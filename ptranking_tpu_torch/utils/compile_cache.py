"""The persistent cache of the CUDA kernels' libraries.

The port's counterpart of ptranking_tpu/utils/compile_cache.py. The JAX
package points jax's compilation cache at a persistent directory, so a
repeated run skips XLA's compiles. Here what a run compiles is the
hand-written kernels of ops/csrc (`nvcc`, tens of seconds for the four
libraries), and ops/cuda_build.py keeps each library under a name that
hashes its sources and flags: a directory of them that outlives the process
is the cache. The same two variables as the JAX package's:

  * PTRANKING_COMPILE_CACHE_DIR redirects `cuda_build.BUILD_DIR` (default
    `build/kernels/` at the repository root, which .gitignore lists);
  * PTRANKING_COMPILE_CACHE=0 turns the cache off: the libraries are built
    into a directory of this process's own, never reused, removed at exit.

The JAX package's PTRANKING_COMPILE_CACHE=1 forces its cache on for a CPU
backend; no kernel is built for the CPU here, so it means what unset means.
`ltr.main` calls `enable_persistent_cache()`, as the JAX CLI does; nothing
is compiled or created when this module is imported.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional

from ptranking_tpu_torch.ops import cuda_build

DEFAULT_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"


def enable_persistent_cache(path: Optional[str] = None) -> Optional[str]:
    """Point cuda_build's library directory at the persistent cache: `path`,
    else PTRANKING_COMPILE_CACHE_DIR, else DEFAULT_DIR. Returns the directory
    in use, or None when PTRANKING_COMPILE_CACHE=0, which points it at a
    fresh directory of this process's own instead."""
    if os.environ.get("PTRANKING_COMPILE_CACHE", "") == "0":
        own = tempfile.mkdtemp(prefix="ptranking_kernels_")
        atexit.register(shutil.rmtree, own, ignore_errors=True)
        cuda_build.BUILD_DIR = Path(own)
        return None
    cache_dir = path or os.environ.get("PTRANKING_COMPILE_CACHE_DIR") or str(DEFAULT_DIR)
    cuda_build.BUILD_DIR = Path(cache_dir)
    return cache_dir
