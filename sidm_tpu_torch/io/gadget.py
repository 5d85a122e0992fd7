"""Gadget format-1 snapshot/IC reader and writer (a numpy copy of
``sidm_tpu/io/gadget.py``; the port's writer gives the same bytes as
JAX's for the same ``Snapshot``).

Binary-compatible with the reference's unformatted-F77-style blocks
(nbody/io.c:54-589, nbody/read_ic.c:32-481; header struct allvars.h:727-746):

    [i4 blklen] 256-byte header [i4 blklen]
    [blk] pos float32 (Ntot,3) [blk]
    [blk] vel float32 (Ntot,3) [blk]
    [blk] id  int32/uint32 (Ntot,) [blk]
    [blk] mass float32 — only particles of types with header.mass[type]==0 [blk]
    [blk] u   float32 (Ngas,) [blk]        (gas only)
    [blk] rho float32 (Ngas,) [blk]        (gas only, written by code)
    [blk] hsml float32 (Ngas,) [blk]       (gas only, written by code)

Multi-file snapshots (``<base>.<i>``) are read and written (io.c
num_files handling). A single file is read by the native reader
(``native/gadget_native.cc`` through ``io/native.py``); unlike the JAX
package, which falls back to numpy when the native library fails, the
port raises: ``use_native=False`` asks for the numpy reader.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

HEADER_SIZE = 256
_HEADER_FMT = "<6i6d d d i i 6i i i d d d d 3i"  # + 84 byte fill


@dataclass
class GadgetHeader:
    npart: np.ndarray = field(default_factory=lambda: np.zeros(6, np.int32))
    mass: np.ndarray = field(default_factory=lambda: np.zeros(6, np.float64))
    time: float = 0.0
    redshift: float = 0.0
    flag_sfr: int = 0
    flag_feedback: int = 0
    npart_total: np.ndarray = field(default_factory=lambda: np.zeros(6, np.int32))
    flag_cooling: int = 0
    num_files: int = 1
    box_size: float = 0.0
    omega0: float = 0.0
    omega_lambda: float = 0.0
    hubble_param: float = 0.0
    flag_multiphase: int = 0
    flag_stellarage: int = 0
    flag_sfrhistogram: int = 0

    def tobytes(self) -> bytes:
        body = struct.pack(
            _HEADER_FMT,
            *[int(x) for x in self.npart],
            *[float(x) for x in self.mass],
            float(self.time), float(self.redshift),
            int(self.flag_sfr), int(self.flag_feedback),
            *[int(x) for x in self.npart_total],
            int(self.flag_cooling), int(self.num_files),
            float(self.box_size), float(self.omega0),
            float(self.omega_lambda), float(self.hubble_param),
            int(self.flag_multiphase), int(self.flag_stellarage),
            int(self.flag_sfrhistogram),
        )
        return body + b"\x00" * (HEADER_SIZE - len(body))

    @classmethod
    def frombytes(cls, raw: bytes) -> "GadgetHeader":
        vals = struct.unpack(_HEADER_FMT, raw[: struct.calcsize(_HEADER_FMT)])
        return cls(
            npart=np.array(vals[0:6], np.int32),
            mass=np.array(vals[6:12], np.float64),
            time=vals[12], redshift=vals[13],
            flag_sfr=vals[14], flag_feedback=vals[15],
            npart_total=np.array(vals[16:22], np.int32),
            flag_cooling=vals[22], num_files=vals[23],
            box_size=vals[24], omega0=vals[25],
            omega_lambda=vals[26], hubble_param=vals[27],
            flag_multiphase=vals[28], flag_stellarage=vals[29],
            flag_sfrhistogram=vals[30],
        )


@dataclass
class Snapshot:
    """Host-side particle data in type-sorted Gadget order."""

    header: GadgetHeader
    pos: np.ndarray          # (N,3) float32
    vel: np.ndarray          # (N,3) float32
    pid: np.ndarray          # (N,)  uint32
    mass: np.ndarray         # (N,)  float32 (filled from header mass table)
    ptype: np.ndarray        # (N,)  int32
    u: Optional[np.ndarray] = None      # (Ngas,)
    rho: Optional[np.ndarray] = None    # (Ngas,)
    hsml: Optional[np.ndarray] = None   # (Ngas,)

    @property
    def n(self) -> int:
        return self.pos.shape[0]


def _read_block(f, expected: Optional[int] = None) -> bytes:
    raw = f.read(4)
    if len(raw) < 4:
        raise EOFError("unexpected end of snapshot file")
    (n,) = struct.unpack("<i", raw)
    if expected is not None and n != expected:
        raise ValueError(f"block length {n} != expected {expected}")
    data = f.read(n)
    (n2,) = struct.unpack("<i", f.read(4))
    if n2 != n:
        raise ValueError(f"block trailer {n2} != header {n}")
    return data


def _write_block(f, data: bytes):
    f.write(struct.pack("<i", len(data)))
    f.write(data)
    f.write(struct.pack("<i", len(data)))


def _snapshot_files(path: str) -> List[str]:
    """Resolve a snapshot basename to its file list (single or multi-file)."""
    if os.path.exists(path):
        return [path]
    files = []
    i = 0
    while os.path.exists(f"{path}.{i}"):
        files.append(f"{path}.{i}")
        i += 1
    if not files:
        raise FileNotFoundError(f"no snapshot found at {path} or {path}.0")
    return files


def _read_native(fn: str) -> Snapshot:
    from .native import read_snapshot_native
    hdr_bytes, pos, vel, pid, mass, u = read_snapshot_native(fn)
    header = GadgetHeader.frombytes(hdr_bytes)
    ptype = np.concatenate([np.full(int(header.npart[t]), t, np.int32)
                            for t in range(6)])
    header.npart_total = header.npart.copy()
    return Snapshot(header=header, pos=pos, vel=vel, pid=pid, mass=mass,
                    ptype=ptype, u=u)


def read_snapshot(path: str, use_native: bool = True) -> Snapshot:
    """Read a format-1 snapshot (all files of a multi-file set). A single
    file goes through the native reader unless ``use_native`` is False;
    the native reader raises where it cannot build, load or read."""
    files = _snapshot_files(path)
    if use_native and len(files) == 1:
        return _read_native(files[0])
    parts = []
    for fn in files:
        with open(fn, "rb") as f:
            header = GadgetHeader.frombytes(_read_block(f, HEADER_SIZE))
            n = int(header.npart.sum())
            ngas = int(header.npart[0])
            pos = np.frombuffer(_read_block(f, 12 * n), np.float32).reshape(n, 3)
            vel = np.frombuffer(_read_block(f, 12 * n), np.float32).reshape(n, 3)
            pid = np.frombuffer(_read_block(f, 4 * n), np.uint32)
            nm = int(sum(header.npart[t] for t in range(6) if header.mass[t] == 0
                         and header.npart[t] > 0))
            mass_block = (np.frombuffer(_read_block(f, 4 * nm), np.float32)
                          if nm > 0 else np.zeros(0, np.float32))
            u = rho = hsml = None
            if ngas > 0:
                u = np.frombuffer(_read_block(f, 4 * ngas), np.float32)
                # rho / hsml blocks are present in code outputs, absent in
                # bare ICs — probe for EOF.
                try:
                    rho = np.frombuffer(_read_block(f, 4 * ngas), np.float32)
                    hsml = np.frombuffer(_read_block(f, 4 * ngas), np.float32)
                except (EOFError, ValueError, struct.error):
                    rho = hsml = None
            parts.append((header, pos, vel, pid, mass_block, u, rho, hsml))

    def cat(idx, empty_shape):
        arrs = [p[idx] for p in parts if p[idx] is not None and len(p[idx])]
        return (np.concatenate(arrs) if arrs
                else np.zeros(empty_shape, np.float32))

    header = parts[0][0]
    npart_total = np.sum([p[0].npart for p in parts], axis=0).astype(np.int32)
    gas = npart_total[0] > 0
    # per-particle types and masses, type-major within each file
    # (read_ic.c:407-413)
    pt_list, m_list = [], []
    for part in parts:
        h, mb, mo = part[0], part[4], 0
        for t in range(6):
            cnt = int(h.npart[t])
            if cnt == 0:
                continue
            pt_list.append(np.full(cnt, t, np.int32))
            if h.mass[t] == 0:
                m_list.append(mb[mo:mo + cnt])
                mo += cnt
            else:
                m_list.append(np.full(cnt, h.mass[t], np.float32))
    n = int(npart_total.sum())
    header.npart_total = npart_total
    header.num_files = len(files)
    return Snapshot(
        header=header, pos=cat(1, (0, 3)), vel=cat(2, (0, 3)),
        pid=cat(3, (0,)).astype(np.uint32),
        mass=np.concatenate(m_list) if m_list else np.zeros(n, np.float32),
        ptype=np.concatenate(pt_list) if pt_list else np.zeros(n, np.int32),
        u=cat(5, (0,)) if gas else None,
        rho=cat(6, (0,)) if gas and parts[0][6] is not None else None,
        hsml=cat(7, (0,)) if gas and parts[0][7] is not None else None)


def write_snapshot(path: str, snap: Snapshot, num_files: int = 1) -> List[str]:
    """Write a format-1 snapshot, optionally split across ``num_files`` files.

    Particles must already be type-sorted (writer sorts defensively). The mass
    table convention follows io.c: a type goes to the mass block iff its
    particles have non-uniform mass, else header.mass[type] carries it.
    """
    order = np.argsort(snap.ptype, kind="stable")
    pos = np.asarray(snap.pos, np.float32)[order]
    vel = np.asarray(snap.vel, np.float32)[order]
    pid = np.asarray(snap.pid, np.uint32)[order]
    mass = np.asarray(snap.mass, np.float32)[order]
    ptype = np.asarray(snap.ptype, np.int32)[order]
    n = pos.shape[0]

    npart = np.array([(ptype == t).sum() for t in range(6)], np.int32)
    mass_table = np.zeros(6, np.float64)
    needs_block = np.zeros(6, bool)
    for t in range(6):
        if npart[t] == 0:
            continue
        mt = mass[ptype == t]
        if np.all(mt == mt[0]) and mt[0] > 0:
            mass_table[t] = mt[0]
        else:
            needs_block[t] = True

    h = snap.header
    header = GadgetHeader(
        npart=npart.copy(), mass=mass_table, time=h.time,
        redshift=h.redshift, flag_sfr=h.flag_sfr,
        flag_feedback=h.flag_feedback, npart_total=npart.copy(),
        flag_cooling=h.flag_cooling, num_files=num_files,
        box_size=h.box_size, omega0=h.omega0, omega_lambda=h.omega_lambda,
        hubble_param=h.hubble_param)

    # split particles across files proportionally (type-major order preserved)
    bounds = [int(round(n * i / num_files)) for i in range(num_files + 1)]
    written = []
    for i in range(num_files):
        lo, hi = bounds[i], bounds[i + 1]
        sl = slice(lo, hi)
        fh = GadgetHeader(**{**header.__dict__})
        fh.npart = np.array([((ptype[sl]) == t).sum() for t in range(6)], np.int32)
        fn = path if num_files == 1 else f"{path}.{i}"
        with open(fn, "wb") as f:
            _write_block(f, fh.tobytes())
            _write_block(f, pos[sl].tobytes())
            _write_block(f, vel[sl].tobytes())
            _write_block(f, pid[sl].tobytes())
            msel = needs_block[ptype[sl]]
            if msel.any():
                _write_block(f, mass[sl][msel].astype(np.float32).tobytes())
            if int(fh.npart[0]) > 0:
                gsl = slice(lo, min(hi, int(npart[0])))
                for blk in (snap.u, snap.rho, snap.hsml):
                    if blk is not None:
                        _write_block(f, np.asarray(blk, np.float32)[gsl].tobytes())
        written.append(fn)
    return written
