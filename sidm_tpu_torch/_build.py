"""Build and bind the package's CUDA kernels.

Each source in ``csrc/`` is compiled at first use by its own ``nvcc``
process, all started together, into a shared library with a plain C
interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 [-fmad=false]
         -Xptxas -v -shared -Xcompiler -fPIC -o _build/lib<name>_<h>.so
         csrc/<name>.cu

``<h>`` hashes the source's own flags, the source and every header, so an
edited file builds anew and an unchanged one is reused. ``-fmad=false`` is
given to ``far_kernel.cu``, ``range_walk.cu``, ``sidm_emit.cu``,
``sidm_gated.cu``, ``sidm_near.cu``, ``hash_knn.cu``, ``hash_scan.cu`` and
``hash_veldisp.cu``: it keeps every product and sum rounded as in the
plain PyTorch version (beside explicit ``__fmul_rn``/``__fadd_rn``), so
that the walks' classifications, the candidate tests, the DSMC keys and the
hash grid's cells, levels, distances and pair terms, and hence every
emitted id, key, radius, count and chosen partner, match the plain
version's exactly.
The other sources are built with FMA: the peak of 67 TFLOP/s that ``bounds.py``
divides by counts an FMA as two operations, so a kernel without FMA can
reach at most half of its bound. Each C entry point
launches on the stream it is given and returns ``cudaGetLastError()`` of
its launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]
# source stem -> flags of its own, after _FLAGS
_SOURCE_FLAGS = {"far_kernel": ["-fmad=false"], "range_walk": ["-fmad=false"],
                 "sidm_emit": ["-fmad=false"], "sidm_gated": ["-fmad=false"],
                 "sidm_near": ["-fmad=false"], "hash_knn": ["-fmad=false"],
                 "hash_scan": ["-fmad=false"],
                 "hash_veldisp": ["-fmad=false"]}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
_IP = ctypes.POINTER(ctypes.c_int)     # a host int array (``int_array``)
# entry point -> (source stem, argument types)
_SIGNATURES = {
    "far_level_launch": ("far_kernel", [
        _P, _I, _P, _P, _I, _I, _P, _P, _P, _P, _F, _I, _F, _I, _I, _I, _I,
        _I, _I, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _F, _F, _I,
        _P]),
    "range_walk_launch": ("range_walk", [
        _P, _IP, _IP, _IP, _I, _I, _P, _P, _P, _P, _I, _F, _F, _I, _I, _I,
        _I, _I, _P, _P, _P, _P, _P, _I, _I, _P]),
    "near_level_launch": ("near_kernel", [
        _P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _P, _F, _F,
        _F, _I, _P]),
    "near_split_launch": ("near_kernel", [_P, _P, _I, _I, _P, _I, _P]),
    "far_list_launch": ("far_list", [
        _P, _I, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P, _I, _P, _P, _F, _F,
        _F, _I, _P]),
    "far_split_launch": ("far_list", [_P, _I, _I, _P, _I, _P]),
    "gather_launch": ("gather", [_P, _I, _P, _L, _P, _P]),
    "rowsum_launch": ("gather", [_P, _I, _P, _L, _P, _P, _P]),
    "sidm_emit_launch": ("sidm_emit", [
        _P, _P, _P, _I, _I, _P, _I, _P, _P, _P, _P, _I, _I, _F, _P, _P, _P,
        _P]),
    "sidm_gated_launch": ("sidm_gated", [
        _P, _P, _I, _I, _P, _P, _P, _P, _I, ctypes.c_uint, _I, _F, _F, _F,
        _F, _F, _P, _P, _P, _P, _P]),
    "sidm_near_launch": ("sidm_near", [
        _P, _P, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P, ctypes.c_uint, _I,
        _F, _F, _F, _F, _F, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P]),
    "segment_totals_launch": ("near_kernel", [_P, _P, _I, _I, _P, _P]),
    "node_rows_launch": ("gather", [_P, _P, _I, _P, _L, _P, _P]),
    "hash_knn_launch": ("hash_knn", [
        _P, _P, _P, _P, _I, _I, _F, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P,
        _P, _P, _P, _P, _P]),
    "hash_scan_launch": ("hash_scan", [
        _P, _P, _I, _P, _P, _P, _I, _I, _F, _P, _P, _P, _P, _P, _P, _P, _I,
        _I, _I, _F, _F, _F, _F, _P, _P, _P, _P, _P, _P]),
    "hash_veldisp_launch": ("hash_veldisp", [
        _P, _P, _P, _P, _I, _I, _F, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P,
        _P, _P, _P]),
    "direct_launch": ("direct", [_P, _P, _P, _I, _P, _I, _P, _P, _P, _P,
                                 _F, _I, _I, _P]),
}

_lib = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def build() -> dict:
    """Compile every source whose library is missing, one ``nvcc`` per
    source, all in parallel. Returns {"paths": {stem: path}, "seconds":
    wall seconds of the parallel build (0.0 when all were reused), "log"}."""
    cus = sorted(_CSRC.glob("*.cu"))
    base = hashlib.sha256()
    for f in sorted(_CSRC.glob("*.cuh")):
        base.update(f.name.encode())
        base.update(f.read_bytes())
    _BUILD.mkdir(exist_ok=True)
    paths, jobs = {}, []
    t0 = time.perf_counter()
    for f in cus:
        flags = _FLAGS + _SOURCE_FLAGS.get(f.stem, [])
        h = base.copy()
        h.update(" ".join(flags).encode())
        h.update(f.read_bytes())
        out = _BUILD / f"lib{f.stem}_{h.hexdigest()[:16]}.so"
        paths[f.stem] = out
        if not out.exists():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
            os.close(fd)
            proc = subprocess.Popen(
                [_nvcc(), *flags, "-o", tmp, str(f)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)
            jobs.append((f, tmp, out, proc))
    logs, failed = [], []
    for f, tmp, out, proc in jobs:
        text, _ = proc.communicate()
        logs.append(f"== {f.name}\n{text}")
        if proc.returncode:
            os.unlink(tmp)
            failed.append(f"{f.name}: nvcc exit {proc.returncode}\n{text}")
        else:
            os.replace(tmp, out)
    secs = time.perf_counter() - t0 if jobs else 0.0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {"paths": paths, "seconds": secs, "log": "\n".join(logs)}


class _Kernels:
    """The C entry points of the built libraries, as attributes."""

    def __init__(self, info: dict):
        self.build_info = info
        self._libs = {stem: ctypes.CDLL(str(path))
                      for stem, path in info["paths"].items()}
        for name, (stem, argtypes) in _SIGNATURES.items():
            fn = getattr(self._libs[stem], name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(self, name, fn)


def kernels_lib() -> _Kernels:
    """The loaded kernel libraries, built at first use."""
    global _lib
    if _lib is None:
        _lib = _Kernels(build())
    return _lib


def int_array(values):
    """A host int32 array argument (``_IP``) holding ``values``."""
    values = [int(v) for v in values]
    return (ctypes.c_int * max(len(values), 1))(*values)


def launch_args(*args):
    """C arguments for an entry point: tensors by data pointer, Python
    scalars and host arrays (``int_array``) as they are, and the current
    CUDA stream last."""
    out = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    out.append(torch.cuda.current_stream().cuda_stream)
    return out


def check_cuda(name: str, **specs):
    """Raise unless every tensor is a contiguous CUDA tensor of the given
    dtype and shape, all on one device. specs: arg -> (tensor, dtype,
    shape)."""
    device = None
    for arg, (t, dtype, shape) in specs.items():
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"{name}: {arg} must be a CUDA tensor")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {arg} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} must have shape {tuple(shape)}, "
                             f"got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
