"""Builds a shared library of the host-side C++ helpers (the JPEG decoder,
the caption index) beside its sources, so that any number of processes may
build and load it at once.

``make`` writes its output in place, so a process that opens the library
while another is still linking it reads a partial file (``ctypes`` raises
``OSError``).  Here the build runs under an exclusive ``fcntl.flock`` on a
lock file beside the library, in a temporary copy of the sources in the
same directory, and the finished library is moved onto its name with
``os.replace``: a reader finds either no file or a whole one.
"""

from __future__ import annotations

import fcntl
import os
import shutil
import subprocess
import tempfile
from typing import Optional, Sequence


def _current(directory: str, path: str, sources: Sequence[str]) -> bool:
    """The library exists and is newer than its Makefile and sources."""
    if not os.path.exists(path):
        return False
    built = os.path.getmtime(path)
    return all(os.path.getmtime(os.path.join(directory, name)) <= built
               for name in ("Makefile", *sources))


def build_library(directory: str, target: str, sources: Sequence[str],
                  force: bool = False) -> Optional[str]:
    """``make target`` of ``directory``'s Makefile, over ``sources`` (file
    names in ``directory``) -> the library's path, or None when it does not
    build.  A library newer than its Makefile and sources is kept unless
    ``force``; so is one that another process finished while this one
    waited for the lock."""
    path = os.path.join(directory, target)
    if not force and _current(directory, path, sources):
        return path
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and _current(directory, path, sources):
            return path
        with tempfile.TemporaryDirectory(prefix="_build_tmp_",
                                         dir=directory) as tmp:
            for name in ("Makefile", *sources):
                shutil.copy2(os.path.join(directory, name), tmp)
            try:
                subprocess.run(["make", "-C", tmp, target], check=True,
                               capture_output=True)
            except (subprocess.CalledProcessError, FileNotFoundError):
                return None
            os.replace(os.path.join(tmp, target), path)
    return path
