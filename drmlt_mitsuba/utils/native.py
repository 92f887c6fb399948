"""Build the native helpers in `<checkout>/native` from source.

The binaries are compiled for the host they run on (the Makefile uses
-march=native), so they are never committed: the first user runs `make`.
"""
from __future__ import annotations

import fcntl
import os
import subprocess

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "native")


def native_path(name: str) -> str:
    return os.path.join(NATIVE_DIR, name)


def build_native(*targets: str, timeout: float = 600) -> None:
    """`make -C native [targets]`, serialized by a lock file so that
    concurrent processes (test workers) do not build over each other.
    Raises subprocess.CalledProcessError with make's output on failure."""
    with open(native_path(".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-C", NATIVE_DIR, *targets], check=True,
                       capture_output=True, text=True, timeout=timeout)
