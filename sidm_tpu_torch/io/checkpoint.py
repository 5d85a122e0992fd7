"""Checkpoint/restart with the reference's trigger semantics (port of
``sidm_tpu/io/checkpoint.py``; the files are the JAX package's, so a
restart written by either package loads in the other).

The reference writes raw binary dumps of All + P[] + SphP[] per task
(nbody/restart.c:37-154), triggered by a ``stop`` file, the 85% CPU-limit
check, the CpuTimeBetRestartFile cadence and end-of-run (run.c:152-211).
Here the whole particle state (``state_dict``: every field, pid uint32)
and the run's scalar variables go to one compressed npz:
``p_<field>`` arrays and ``run_vars_json`` (uint8 bytes of a JSON object
with ``format_version`` 1), written to a temporary file and renamed into
place.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np

from ..state import Particles, state_dict, state_from_dict

FORMAT_VERSION = 1


def write_restart(path_base: str, particles: Particles, run_vars: dict) -> str:
    """Write ``<path_base>.npz``. ``run_vars`` holds the scalar loop state
    (time, step count, snapshot count, last statistics time, ...)."""
    os.makedirs(os.path.dirname(path_base) or ".", exist_ok=True)
    payload = {f"p_{k}": v for k, v in state_dict(particles).items()}
    payload["run_vars_json"] = np.frombuffer(
        json.dumps({"format_version": FORMAT_VERSION, **run_vars}).encode(),
        dtype=np.uint8)
    tmp = path_base + ".tmp.npz"
    np.savez_compressed(tmp, **payload)
    final = path_base + ".npz"
    os.replace(tmp, final)
    return final


def read_restart(path_base: str, device=None) -> Tuple[Particles, dict]:
    """(particles on ``device``, run variables) of a restart file."""
    fn = path_base if path_base.endswith(".npz") else path_base + ".npz"
    with np.load(fn) as z:
        run_vars = json.loads(bytes(z["run_vars_json"]).decode())
        if run_vars.pop("format_version") != FORMAT_VERSION:
            raise ValueError("restart file format version mismatch")
        arrays = {k[2:]: z[k] for k in z.files if k.startswith("p_")}
    return state_from_dict(arrays, device=device), run_vars


def stopfile_present(output_dir: str) -> bool:
    """run.c:152-160: presence of <OutputDir>/stop interrupts the run."""
    return os.path.exists(os.path.join(output_dir, "stop"))


def read_scatter_log(path: str):
    """Decode a sct_XXX file (SCATTERLOG, struct scatlog sidm.h:1-10).

    Returns (time, id1, id2, rest) where ids are exact int32 and rest is
    the (n_events, 17) float block [h1, h2, x1(3), x2(3), v1(3), v2(3),
    dv(3)]."""
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 20)
    ids = raw[:, 1:3].view(np.int32)
    return raw[:, 0], ids[:, 0], ids[:, 1], raw[:, 3:]
