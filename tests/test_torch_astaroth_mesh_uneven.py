"""Astaroth over an uneven mesh, in the port on 8 ``"cpu"`` positions
against the JAX package on its 8 virtual CPU devices (helpers, inputs and
tolerances: ``test_torch_astaroth_mesh.py``): 19x16x14 over (2,2,2), blocks
of 10/9, 8/8 and 7/7 (``tests/test_astaroth.py``'s uneven case), each task
at its block's own extent and B6's uneven ring between them. The port
takes the serialized order on an uneven partition (its overlap argument
changes nothing there); the JAX package's overlap step re-integrates
dynamic-offset shells after a masked interior pass, which gives the same
cells, since stage 0 never reads ``out``: the port's step is held to both
JAX steps, each compiled once."""

import numpy as np
import pytest

from stencil_tpu_torch.astaroth.integrate import FIELDS
from test_torch_astaroth_mesh import mesh_matches_jax, port_run

SIZE = (19, 16, 14)


@pytest.mark.parametrize("jmode", ["serial", "overlap"])
def test_uneven_mesh_matches_jax(jmode):
    mesh_matches_jax((2, 2, 2), (2, 2, 2), "overlap", jmode=jmode, size=SIZE)


def test_uneven_mesh_overlap_is_the_serialized_step():
    """On an uneven mesh the overlap step is the serialized one, bit for
    bit, and both equal the resident uneven step."""
    over, _ = port_run(SIZE, (2, 2, 2), (2, 2, 2), "overlap")
    serial, _ = port_run(SIZE, (2, 2, 2), (2, 2, 2), "serial")
    from test_torch_astaroth_resident import port_run as resident_run

    resident, _ = resident_run(SIZE, (2, 2, 2), "serial")
    for k in FIELDS:
        assert np.array_equal(over[k], serial[k]), k
        assert np.array_equal(over[k], resident[k]), k


def test_uneven_mesh_f32_matches_jax():
    """fp32, within rtol 1e-4 / atol 1e-5."""
    mesh_matches_jax((2, 2, 2), (2, 2, 2), "serial", np.float32, size=SIZE)
