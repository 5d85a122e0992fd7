"""ctypes binding of the native Gadget reader (port of
``sidm_tpu/io/native.py``; the library is ``native/gadget_native.cc``).

At first use g++ compiles that source into ``sidm_tpu_torch/_build/``
(``libgadget_native_<hash>.so``, the hash of the source and flags): into a
temporary file first, then renamed into place, so that processes building
at once (pytest-xdist workers) each load a whole library. Where the JAX
package returns None and its caller falls back to numpy, this module
raises: a failed build, load or read is an error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
_SOURCE = _PKG.parent / "native" / "gadget_native.cc"
_BUILD = _PKG / "_build"
_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lib = None


def build() -> Path:
    """Compile the library unless it is there already; returns its path."""
    if not _SOURCE.exists():
        raise FileNotFoundError(f"native reader source {_SOURCE} is missing")
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SOURCE.read_bytes())
    out = _BUILD / f"libgadget_native_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native Gadget reader needs a "
                           "C++ compiler (or pass use_native=False)")
    _BUILD.mkdir(exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *_FLAGS, "-o", tmp, str(_SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"building the native Gadget reader failed "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.gadget_read_header.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
        lib.gadget_read_header.restype = ctypes.c_int
        lib.gadget_read_body.argtypes = [ctypes.c_char_p] + \
            [ctypes.c_void_p] * 5
        lib.gadget_read_body.restype = ctypes.c_int
        _lib = lib
    return _lib


def read_snapshot_native(path: str):
    """Read one format-1 file: (header_bytes, pos, vel, pid uint32, mass,
    u or None). Raises OSError where the file cannot be read as one."""
    lib = _load()
    hdr = np.zeros(256, np.uint8)
    rc = lib.gadget_read_header(path.encode(), hdr.ctypes.data)
    if rc:
        raise OSError(f"native Gadget reader: no header in {path} (rc {rc})")
    npart = np.frombuffer(hdr.tobytes()[:24], np.int32)
    n = int(npart.sum())
    ngas = int(npart[0])
    pos = np.empty((n, 3), np.float32)
    vel = np.empty((n, 3), np.float32)
    pid = np.empty(n, np.uint32)
    mass = np.empty(n, np.float32)
    u = np.zeros(max(ngas, 1), np.float32)
    rc = lib.gadget_read_body(path.encode(), pos.ctypes.data,
                              vel.ctypes.data, pid.ctypes.data,
                              mass.ctypes.data, u.ctypes.data)
    if rc:
        raise OSError(f"native Gadget reader: {path} is not a whole "
                      f"format-1 file (rc {rc})")
    return hdr.tobytes(), pos, vel, pid, mass, (u[:ngas] if ngas else None)
