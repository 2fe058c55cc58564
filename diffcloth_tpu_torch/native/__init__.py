"""Native host components of the port, built with g++ at first use.

Counterpart of `diffcloth_tpu/native/`: `diffcloth_native.cpp` (the
port's own copy of the JAX package's source) is compiled into
`build/native/` at the repository root (git-ignored) the first time
`fastobj` calls into it, never at import; the library's name hashes the
source and the flags, so an edited source is rebuilt and an unchanged one
reused.  `fastobj` is the ctypes binding.
"""
from __future__ import annotations

import hashlib
import os
import subprocess
import tempfile
import threading

NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(NATIVE_DIR, "diffcloth_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(NATIVE_DIR)),
                         "build", "native")
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()


def library_path() -> str:
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SRC, "rb") as fh:
        digest.update(fh.read())
    return os.path.join(BUILD_DIR,
                        f"libdiffcloth_native_{digest.hexdigest()[:12]}.so")


def ensure_built() -> str:
    """The library's path, built with g++ first if it is not there (into a
    temporary name, then moved in place, so concurrent builders never load
    a partial file).  Raises CalledProcessError with g++'s output."""
    lib = library_path()
    with _lock:
        if not os.path.exists(lib):
            os.makedirs(BUILD_DIR, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run(["g++", *FLAGS, "-o", tmp, SRC], check=True,
                               capture_output=True, text=True)
                os.replace(tmp, lib)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return lib
