"""Astaroth over the mixed and the oversubscribed meshes, in the port on
``["cpu"] * n`` positions against the JAX package on as many of its virtual
CPU devices (helpers, inputs and tolerances: ``test_torch_astaroth_mesh.py``):
the (1,1,2) mesh over 2 positions (x and y wrap onto themselves through
B4's plain fill, z crosses by B6's), with overlap and without, and (2,2,2)
blocks on 4 positions ((2,2,1), 2 residents each) and on 2 positions
((2,1,1), 4 residents each), as in ``tests/test_astaroth.py``'s
oversubscribed cases; each JAX step compiled once."""

import numpy as np
import pytest

from stencil_tpu_torch.astaroth.integrate import FIELDS
from test_torch_astaroth_mesh import mesh_matches_jax, port_run


@pytest.mark.parametrize("mode", ["overlap", "serial"])
def test_mixed_mesh_on_2_positions_matches_jax(mode):
    mesh_matches_jax((1, 1, 2), (1, 1, 2), mode, size=(16, 16, 20))


@pytest.mark.parametrize("mesh_dim", [(2, 2, 1), (2, 1, 1)], ids=["4 positions", "2 positions"])
def test_oversubscribed_mesh_matches_jax(mesh_dim):
    """(2,2,2) blocks over fewer positions: every position's stack of
    residents steps in the one launch a stage, B6 takes every block as an
    endpoint; against the JAX step over as many devices."""
    got = mesh_matches_jax((2, 2, 2), mesh_dim, "overlap")
    over, _ = port_run((16, 16, 16), (2, 2, 2), (2, 2, 2), "overlap")
    for k in FIELDS:
        assert np.array_equal(got[k], over[k]), k  # the same cells as one block a position
