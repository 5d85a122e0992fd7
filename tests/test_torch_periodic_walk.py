"""The plain periodic modes of the walk's kernels (sidm_tpu_torch/ops/
fused_force.py ``classify(pbc=)``, ``far_tile_pbc``, ``near_tile(pbc=)``,
the tiles of ``far_level_plain``, ``far_list_plain`` and
``near_level_plain``) against the JAX package's ``_classify(pbc)``,
``_far_tile_pbc`` and ``_near_tile(pbc)``, on the CPU, on random node rows,
group boxes (one dead group, parked as the walk parks it) and segment keys
frozen with JAX's outputs in tests/data/torch_periodic_golden.npz (``cl``,
``ft``, ``nt``; tests/make_torch_golden.py ``periodic``).

Tolerances: the classification's planes equal; the far tile within 2e-5
and the near tile within 1e-5 of JAX's largest magnitude (erf, erfc and
exp by torch and by XLA; the screened potential beyond the softening as
-erfc(a r)/r, JAX's as -1/r + erf(a r)/r). The record mode refuses a box.
"""

import numpy as np
import pytest
import torch

from sidm_tpu_torch.ops.far_kernel import far_level, list_buf
from sidm_tpu_torch.ops.fused_force import (IMAX, classify, far_tile_pbc,
                                            near_tile)
from tests.make_torch_golden import PERIODIC_GOLDEN, TILE, tile_inputs

torch.set_num_threads(2)
PBC = (TILE["box"], TILE["alpha"], TILE["rcut"])


@pytest.fixture(scope="module")
def golden():
    with np.load(PERIODIC_GOLDEN) as z:
        return {k: z[k] for k in z.files if k[:2] in ("cl", "ft", "nt")}


@pytest.fixture(scope="module")
def t():
    return {k: torch.tensor(v) for k, v in tile_inputs().items()}


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("rel", [False, True])
def test_classify_pbc_matches_jax(golden, t, last, rel):
    planes = classify(t["rows"], t["glo"], t["ghi"], t["oac"], t["s_l"],
                      0.25, rel, 16, last, PBC)
    for name, pl in zip(("far", "seg", "opn", "big"), planes):
        want = golden[f"cl{int(last)}{int(rel)}_{name}"]
        assert np.array_equal(pl.numpy(), want), name
    # the dead group reaches nothing; the cut drops some live cells
    assert not any(bool(pl[-1].any()) for pl in planes)
    live = (t["rows"][..., 4] > 0).sum()
    assert sum(int(pl.sum()) for pl in planes) < int(live)


def close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= tol * np.abs(b).max()


@pytest.mark.parametrize("need_pot", [False, True])
def test_far_tile_pbc_matches_jax(golden, t, need_pot):
    far = torch.tensor(golden["ft_far"])
    rows = t["rows"].clone()
    rows[..., 3] = torch.where(far, rows[..., 3], torch.zeros_like(rows[..., 3]))
    trq = torch.where(far, t["trq"], torch.zeros_like(t["trq"]))
    da, dp = far_tile_pbc(rows, trq, t["xr"], t["te"], PBC, need_pot)
    close(da, golden[f"ft{int(need_pot)}_acc"], 2e-5)
    if need_pot:
        close(dp, golden["ft1_pot"], 2e-5)


@pytest.mark.parametrize("need_pot", [False, True])
def test_near_tile_pbc_matches_jax(golden, t, need_pot):
    da, dp = near_tile(t["ent"], t["ppos"], t["pmass"], t["peps"], t["xr"],
                       t["te"], need_pot, PBC)
    close(da, golden[f"nt{int(need_pot)}_acc"], 1e-5)
    if need_pot:
        close(dp, golden["nt1_pot"], 1e-5)


def test_record_mode_refuses_a_box(t):
    ng, W = 4, 8
    with pytest.raises(NotImplementedError, match="item 11"):
        far_level(torch.zeros(ng, W, dtype=torch.int32),
                  torch.zeros(ng, dtype=torch.int32), t["rows"][0], 8,
                  t["s_l"], t["glo"][:ng], t["ghi"][:ng], t["oac"][:ng],
                  theta2=0.25, use_relative=False, leaf_cap=16, last=False,
                  Wn=W, open_cap=W, big_cap=8, big_chunks=8,
                  lists=list_buf(ng, 16, 16, "cpu"), pbc=PBC)
    assert IMAX == 2147483647
