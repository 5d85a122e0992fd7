"""Command-line entry point (port of ``sidm_tpu/cli.py``).

Usage mirrors the reference (`mpirun -n N ./sidm-gadget parameter.txt
[restartflag]`, nbody/main.c:39-70) without the MPI launcher:

    python -m sidm_tpu_torch <parameterfile> [restartflag]

restartflag: 0 = start from InitCondFile (default), 1 = resume from restart
file, 2 = start from a snapshot file (main.c:67-70, begrun.c:49-117).

The run goes on the CUDA card (``cuda:0``; with more than one card visible
it says so on stderr: the multi-device runner is not ported, ROADMAP.md A,
item 14); without a card it raises. ``main(argv, device="cpu")`` runs on
the CPU, as the tests do.
"""

from __future__ import annotations

import sys

import torch

from .simulation import Simulation, resolve_device


def main(argv=None, device=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__)
        return 1
    param_file = argv[0]
    restart_flag = int(argv[1]) if len(argv) > 1 else 0
    if device is None:
        if torch.cuda.is_available() and torch.cuda.device_count() > 1:
            print(f"{torch.cuda.device_count()} CUDA cards visible: running "
                  "on cuda:0 only (the multi-device runner is not ported, "
                  "ROADMAP.md A, item 14)", file=sys.stderr)
        device = resolve_device("cuda:0" if torch.cuda.is_available()
                                else None)

    sim = Simulation.from_parameter_file(param_file, restart_flag=restart_flag,
                                         device=device)
    if restart_flag == 1:
        sim.load_restart_file()
    else:
        sim.load_ic()
    sim.prepare()
    try:
        steps = sim.run()
    finally:
        sim.close_logs()
    print(f"run finished: {steps} steps, t = {sim.time:g}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
