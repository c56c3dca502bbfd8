"""Builds and loads the port's native libraries.

Used by align/native.py (g++, TM-align) and ops/_build.py (nvcc, the scan
kernels). Every library is built from the sources in the checkout into one
directory inside the package, `_build/`, which `.gitignore` lists:

- **Content-keyed names.** A library's file name carries a hash of its
  sources and flags (and, for `-march=native` host code, of the host CPU),
  so an edited source or another host rebuilds instead of loading a stale
  or foreign-ISA copy.
- **Atomic publish.** The compiler writes to a temporary name in the same
  directory that is renamed into place, so a killed build never leaves a
  truncated library that a later process would trust.
- **No silent fallback.** A failed build raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile

logger = logging.getLogger(__name__)

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_build")

_GXX = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"]
_NATIVE_FLAGS = ["-march=native", "-funroll-loops"]


def content_tag(paths: list[str], extra: list[str]) -> str:
    """Short hash of the files' bytes and the extra strings (flags)."""
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as fh:
            h.update(fh.read())
    h.update("\0".join(extra).encode())
    return h.hexdigest()[:16]


def _cpu_tag() -> str:
    """Short fingerprint of the host CPU's ISA surface."""
    try:
        with open("/proc/cpuinfo") as fh:
            lines = fh.read(65536).splitlines()
        keep = [ln for ln in lines
                if ln.startswith(("model name", "flags", "Features"))]
        blob = "".join(keep[:2])
    except OSError:
        import platform
        blob = platform.machine() + platform.processor()
    return hashlib.sha256(blob.encode()).hexdigest()[:10]


def run_compiler(cmd: list[str], timeout: float = 600) -> str:
    """Run a compiler command; raise RuntimeError with its output on failure.
    Returns the compiler's combined output (e.g. ptxas register reports)."""
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=timeout)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"{cmd[0]} failed to run: {e}") from e
    if res.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} exited {res.returncode}:\n"
                           f"{res.stdout}{res.stderr}"[-4000:])
    return res.stdout + res.stderr


def temp_path(suffix: str) -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=suffix, dir=BUILD_DIR)
    os.close(fd)
    return tmp


def build_native_lib(src: str, name: str) -> str:
    """Path of the g++-built shared library for `src`, building it first
    when `_build/` has no copy. Tries a host-tuned build, then a generic
    one; raises RuntimeError when neither compiles."""
    errors = []
    for flavor, extra in (("mn", _NATIVE_FLAGS), ("gen", [])):
        tag = content_tag([src], _GXX + extra + [_cpu_tag() if extra else ""])
        lib = os.path.join(BUILD_DIR, f"lib{name}-{tag}-{flavor}.so")
        if os.path.exists(lib):
            return lib
        tmp = temp_path(".so")
        try:
            run_compiler(_GXX + extra + ["-o", tmp, src, "-lpthread"], 300)
            os.replace(tmp, lib)
            return lib
        except RuntimeError as e:
            errors.append(str(e))
            logger.warning("native %s build (%s) failed", name, flavor)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    raise RuntimeError(f"could not build native {name}:\n" + "\n".join(errors))


def load_native_lib(src: str, name: str) -> ctypes.CDLL:
    """build_native_lib + CDLL."""
    return ctypes.CDLL(build_native_lib(src, name))
