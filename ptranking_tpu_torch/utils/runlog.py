"""Run-directory log capture.

The port's copy of ptranking_tpu/utils/runlog.py. While active, a tee writes
stdout both to the console and to `log_<timestamp>.txt` in the run
directory, so a long k-fold or grid run leaves an on-disk record of every
line it printed.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import sys
from typing import Iterator, Optional

from ptranking_tpu_torch.parallel.collectives import is_writer


class _Tee:
    """File-like object duplicating writes to a console stream and a file.

    Python-level writes only: `fileno()` is the console's, so subprocesses
    and native printers keep writing to the console, and their output does
    not reach the log file."""

    def __init__(self, console, logfile):
        self._console = console
        self._file = logfile

    def write(self, s: str) -> int:
        n = self._console.write(s)
        self._file.write(s)
        return n

    def writelines(self, lines) -> None:
        for s in lines:
            self.write(s)

    def flush(self) -> None:
        self._console.flush()
        self._file.flush()

    def isatty(self) -> bool:
        return self._console.isatty()

    def fileno(self) -> int:
        return self._console.fileno()

    @property
    def buffer(self):
        # binary writes go to the console only (see the class docstring)
        return getattr(self._console, "buffer", self._console)


@contextlib.contextmanager
def run_log(dir_run: Optional[str], enabled: bool = True,
            debug: bool = False) -> Iterator[Optional[str]]:
    """Tee stdout to `<dir_run>/log_<YYYY_mm_dd_HH_MM>.txt` while active; no
    capture when disabled or in debug mode. Yields the log's path (None when
    disabled). Nested use layers another tee and unwinds in order. In a
    process group only rank 0 writes the log."""
    if not enabled or debug or not dir_run or not is_writer():
        yield None
        return
    os.makedirs(dir_run, exist_ok=True)
    time_str = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M")
    path = os.path.join(dir_run, f"log_{time_str}.txt")
    # append: the folds and grid points of one run share the file
    with open(path, "a", encoding="utf-8") as f:
        prev = sys.stdout
        sys.stdout = _Tee(prev, f)
        try:
            yield path
        finally:
            sys.stdout = prev
