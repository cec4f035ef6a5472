"""Build the hand-written CUDA kernels under ops/csrc/ and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by `nvcc`
for Hopper (`sm_90a`) into `build/kernels/lib<name>-<hash>.so` at the repo
root, at first use. The file name carries a hash of the source, of the
headers it includes (`#include "..."`, such as `csrc/mma_common.cuh`) and of
the flags, so an edited source or header is rebuilt and a stale library is
never loaded. Nothing is compiled or loaded when this module is imported.

Every entry returns a cudaError_t as an int, and each library exports
`<name>_error_string(int)`; `KernelLib` binds the entries' ctypes signatures
and turns a nonzero return into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "build only on a machine with the CUDA toolkit")
    return found


def source_files(src: Path) -> List[Path]:
    """`src` and every file it includes by `#include "..."` (beside the
    including file, where nvcc looks first), recursively, in the order first
    met; raises if one is missing."""
    files: List[Path] = []
    todo = [src.resolve()]
    while todo:
        path = todo.pop(0)
        if path in files:
            continue
        files.append(path)
        for inc in _INCLUDE.findall(path.read_text()):
            found = path.parent / inc
            if not found.exists():
                raise FileNotFoundError(f'{path.name}: #include "{inc}" not found')
            todo.append(found.resolve())
    return files


def library_path(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in source_files(CSRC / f"{name}.cu"):
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def nvcc(src: Path, out: Path) -> subprocess.Popen:
    """Start compiling `src` into the shared library `out` with NVCC_FLAGS
    (and CSRC on the include path, so that a copy of a kernel source built
    elsewhere finds the headers); the compiler's output (with -Xptxas -v) is
    the process's stdout."""
    return subprocess.Popen([find_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _start(name: str) -> "subprocess.Popen | None":
    lib = library_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return nvcc(CSRC / f"{name}.cu", lib.with_suffix(f".{os.getpid()}.tmp"))


def build(names: Iterable[str]) -> List[str]:
    """Compile every named kernel that is not built yet, all `nvcc`s started
    together. Returns the compiler's output (register and shared-memory use
    from `-Xptxas -v`) for each kernel it compiled; raises if any build fails."""
    names = list(names)
    procs = {n: _start(n) for n in names}
    logs, failed = [], []
    for n, proc in procs.items():
        if proc is None:
            continue
        out, _ = proc.communicate()
        lib = library_path(n)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        if proc.returncode != 0:
            failed.append(f"{n}: nvcc exited {proc.returncode}\n{out}")
            continue
        os.replace(tmp, lib)  # atomic: a reader never sees a half-written .so
        logs.append(f"{n}:\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def all_kernels() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LOADED[name] = lib
    return lib


class KernelLib:
    """One `csrc/<name>.cu` library with its entries' ctypes argument types,
    loaded (and built if needed) at the first `call`."""

    def __init__(self, name: str, signatures: Dict[str, list]):
        self.name = name
        self._signatures = signatures
        self._lib = None

    def call(self, entry: str, *args) -> None:
        """Run one entry; raises if it returns a CUDA error (a refused launch)."""
        if self._lib is None:
            lib = load(self.name)
            for fn_name, argtypes in self._signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            err_fn = getattr(lib, f"{self.name}_error_string")
            err_fn.argtypes = [ctypes.c_int]
            err_fn.restype = ctypes.c_char_p
            self._lib = lib
        err = getattr(self._lib, entry)(*args)
        if err != 0:
            msg = getattr(self._lib, f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{entry} launch failed: CUDA error {err} ({msg})")
