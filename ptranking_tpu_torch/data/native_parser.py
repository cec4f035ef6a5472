"""ctypes wrapper of the native LETOR parser (native/letor_parser.cpp).

Counterpart of ptranking_tpu/data/native_parser.py, over the same unchanged
C++ source, built by the port's own helper into `build/native/`
(utils/native_build.py). `parse_letor_file_native(path, ...)` returns what
`parse_letor_lines` (data/letor.py) returns, (features [R, F] float32,
labels [R] float32, qids list[, docids list]), parsed in C++: the host path
for MSLR- and Istella-scale files. It returns None when no C++ compiler
exists or the library rejects the file; `load_letor_file` then parses in
Python, which stays the oracle.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

from ptranking_tpu_torch.utils.native_build import NATIVE_BUILD_DIR, NATIVE_SRC_DIR, build_native

LIB_PATH = os.path.join(NATIVE_BUILD_DIR, "libletor_parser.so")


class _Library:
    """The loaded library, built at first use; one per process."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self._failed = False

    def get(self) -> Optional[ctypes.CDLL]:
        with self._lock:
            if self._lib is None and not self._failed:
                try:
                    self._lib = self._load()
                except (OSError, RuntimeError, subprocess.CalledProcessError) as exc:
                    # no compiler, a failed compile or dlopen: parse in Python instead
                    print(f" [native_parser] unavailable ({type(exc).__name__}: {exc})")
                    self._failed = True
            return self._lib

    @staticmethod
    def _load() -> ctypes.CDLL:
        built = build_native(os.path.join(NATIVE_SRC_DIR, "letor_parser.cpp"), LIB_PATH,
                             extra_flags=["-shared", "-fPIC"])
        if built is None:
            raise RuntimeError("no C++ compiler or no native/letor_parser.cpp")
        lib = ctypes.CDLL(built)
        lib.letor_parse.restype = ctypes.c_void_p
        lib.letor_parse.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.letor_dims.restype = None
        lib.letor_dims.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.letor_fill.restype = None
        lib.letor_fill.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_char_p, ctypes.c_char_p,
        ]
        lib.letor_close.restype = None
        lib.letor_close.argtypes = [ctypes.c_void_p]
        return lib


_LIBRARY = _Library()


def native_parser_available() -> bool:
    return _LIBRARY.get() is not None


def _split_nul(buf, n: int) -> List[str]:
    return buf.raw[:n].decode("iso-8859-1").split("\0")[:-1] if n else []


def parse_letor_file_native(path: str, has_targets: bool = True, one_indexed: bool = True,
                            has_comment: bool = False):
    """Parse a LETOR/LibSVM file in C++; returns parse_letor_lines' tuple, or
    None when the library is unavailable or rejects the file."""
    lib = _LIBRARY.get()
    if lib is None:
        return None
    handle = lib.letor_parse(os.fsencode(path), int(one_indexed), int(has_targets))
    if not handle:
        return None
    try:
        rows, nf = ctypes.c_int64(), ctypes.c_int32()
        qbytes, dbytes, has_docids = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int32()
        lib.letor_dims(handle, ctypes.byref(rows), ctypes.byref(nf), ctypes.byref(qbytes),
                       ctypes.byref(dbytes), ctypes.byref(has_docids))
        feats = np.zeros((rows.value, nf.value), np.float32)
        labels = np.zeros((rows.value,), np.float32)
        qbuf = ctypes.create_string_buffer(max(qbytes.value, 1))
        dbuf = ctypes.create_string_buffer(max(dbytes.value, 1))
        lib.letor_fill(handle, feats.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                       labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), qbuf, dbuf)
        qids = _split_nul(qbuf, qbytes.value)
        if has_comment:
            return feats, labels, qids, _split_nul(dbuf, dbytes.value)
        return feats, labels, qids
    finally:
        lib.letor_close(handle)
