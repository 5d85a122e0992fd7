"""Reader for Bepi Tormen's ZIC cluster initial conditions (a copy of
``sidm_tpu/io/zic.py``, which imports no JAX; ``ICFormat 3``).

Parity with the reference's special-purpose reader (read_ic_cluster.c:20-384):
Fortran-record file holding a header {nhr, nlr, a0[, pmhr]} followed by
high-resolution particle blocks then low-resolution blocks of at most 1e6
particles each; every block is {npart} + pos record + vel record + (LR only)
mass record. Unit factors and the LR zone boundary follow the reference
(read_ic_cluster.c:49-51, 339): positions scale to kpc/h, comoving velocities
to the u = v * sqrt(a) variable, HR masses come from the header pmhr, and LR
particles outside ``lr_boundary`` are reassigned type 2 -> 3.

The reference streams blocks over MPI ranks; here the host reads the whole
file into numpy arrays, which ``Simulation.load_ic`` moves to the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

_BLOCK = 1_000_000  # particles per ZIC block (read_ic_cluster.c:151-152)


@dataclass
class ZicData:
    pos: np.ndarray      # (n, 3) float64, kpc/h
    vel: np.ndarray      # (n, 3) float64, u = sqrt(a) * xdot, km/s
    mass: np.ndarray     # (n,) float64, 1e10 Msun/h
    ptype: np.ndarray    # (n,) int32: 1 = HR halo, 2 = inner LR, 3 = outer LR
    pid: np.ndarray      # (n,) uint32, 1-based
    time: float          # scale factor a0 from the header
    pmhr: float          # raw HR particle mass from the header (or 1.0)


class _RecordFile:
    """Fortran unformatted sequential records (4-byte length markers)."""

    def __init__(self, fname):
        self._f = open(fname, "rb")

    def close(self):
        self._f.close()

    def record(self, dtype, count=None):
        head = np.fromfile(self._f, dtype=np.int32, count=1)
        if head.size == 0:
            raise EOFError("unexpected end of ZIC file")
        nbytes = int(head[0])
        item = np.dtype(dtype).itemsize
        n = nbytes // item if count is None else count
        data = np.fromfile(self._f, dtype=dtype, count=n)
        if data.size != n:
            raise EOFError("truncated ZIC record")
        skip = nbytes - n * item
        if skip:
            self._f.seek(skip, 1)
        tail = np.fromfile(self._f, dtype=np.int32, count=1)
        if tail.size == 0 or int(tail[0]) != nbytes:
            raise ValueError("corrupt ZIC record marker")
        return data, nbytes


def default_massfac(g: float, posfac: float = 141300.0,
                    npart_base: float = 760.0) -> float:
    """The reference's hard-wired mass factor (read_ic_cluster.c:49):
    0.3 * 3 * 0.1^2 / (8 pi G) * (posfac / npart_base)^3."""
    return 0.3 * 3 * 0.1 * 0.1 / (8.0 * math.pi * g) \
        * (posfac / npart_base) ** 3


def read_ic_cluster(fname, g: float, *, posfac: float = 141300.0,
                    velfac: float = 14130.0, massfac: float = None,
                    pmhr: float = 1.0, lr_boundary: float = 24000.0,
                    time: float = None) -> ZicData:
    """Read a ZIC cluster IC file into host arrays.

    ``g`` is the gravitational constant in internal units (for the default
    mass factor). ``pmhr`` is only used for the old header layout without an
    embedded HR mass. ``time`` overrides the header scale factor used in the
    velocity transform (the reference uses All.Time, set from the parameter
    file; the header a0 is the natural default).
    """
    if massfac is None:
        massfac = default_massfac(g, posfac)

    f = _RecordFile(fname)
    try:
        head, nbytes = f.record(np.float32)
        ints = head[:2].view(np.float32).tobytes()
        nhr, nlr = np.frombuffer(ints, dtype=np.int32)
        a0 = float(head[2])
        if nbytes == 16:
            pmhr = float(head[3])
        a = a0 if time is None else float(time)
        sqr_a = math.sqrt(a)

        n_total = int(nhr) + int(nlr)
        pos = np.empty((n_total, 3), np.float64)
        vel = np.empty((n_total, 3), np.float64)
        mass = np.empty(n_total, np.float64)
        ptype = np.empty(n_total, np.int32)

        nhr_blocks = int(nhr) // _BLOCK + 1
        nlr_blocks = int(nlr) // _BLOCK + 1
        off = 0
        for b in range(nhr_blocks + nlr_blocks):
            hr = b < nhr_blocks
            (npart,), _ = f.record(np.int32, count=1)
            npart = int(npart)
            bpos, _ = f.record(np.float32, count=3 * npart)
            pos[off:off + npart] = bpos.reshape(npart, 3)
            bvel, _ = f.record(np.float32, count=3 * npart)
            vel[off:off + npart] = bvel.reshape(npart, 3)
            if hr:
                mass[off:off + npart] = pmhr * massfac
                ptype[off:off + npart] = 1
            else:
                bm, _ = f.record(np.float32, count=npart)
                mass[off:off + npart] = bm * massfac
                ptype[off:off + npart] = 2
            off += npart
        if off != n_total:
            raise ValueError(
                f"ZIC blocks hold {off} particles, header says {n_total}")
    finally:
        f.close()

    pos *= posfac
    vel *= velfac * sqr_a
    r = np.linalg.norm(pos, axis=1)
    outer = (ptype == 2) & (r > lr_boundary)
    ptype[outer] = 3

    return ZicData(pos=pos, vel=vel, mass=mass, ptype=ptype,
                   pid=np.arange(1, n_total + 1, dtype=np.uint32),
                   time=a0, pmhr=pmhr)


def write_zic(fname, pos_hr, vel_hr, pos_lr, vel_lr, mass_lr, a0,
              pmhr: float = None):
    """Write a ZIC file (testing aid; new-format header iff pmhr given)."""
    def rec(f, arr):
        b = np.asarray(arr).tobytes()
        np.int32(len(b)).tofile(f)
        f.write(b)
        np.int32(len(b)).tofile(f)

    nhr, nlr = len(pos_hr), len(pos_lr)
    with open(fname, "wb") as f:
        head = [np.int32(nhr).tobytes(), np.int32(nlr).tobytes(),
                np.float32(a0).tobytes()]
        if pmhr is not None:
            head.append(np.float32(pmhr).tobytes())
        b = b"".join(head)
        np.int32(len(b)).tofile(f)
        f.write(b)
        np.int32(len(b)).tofile(f)
        for (p, v, m) in ((pos_hr, vel_hr, None), (pos_lr, vel_lr, mass_lr)):
            rec(f, np.array([len(p)], np.int32))
            rec(f, np.asarray(p, np.float32).reshape(-1))
            rec(f, np.asarray(v, np.float32).reshape(-1))
            if m is not None:
                rec(f, np.asarray(m, np.float32))
