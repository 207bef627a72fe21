"""Astaroth over resident blocks, the port against the JAX package on one
CPU device: the step on (1, 1, 2) with overlap on and off, the hoisted
order against the serialized one (helpers and tolerances:
``test_torch_astaroth_resident.py``), and an uneven partition against the
JAX package's serialized path."""

import numpy as np
import pytest
import torch

from test_torch_astaroth_resident import (assert_close, overlap_matches_serial, run_both, specs,
                                          step_matches_jax)

torch.set_num_threads(2)


@pytest.mark.parametrize("mode", ["overlap", "serial"])
def test_step_matches_jax(mode):
    step_matches_jax((1, 1, 2), mode)


def test_overlap_matches_serial():
    overlap_matches_serial((1, 1, 2))


def test_uneven_step_matches_jax_serialized():
    """19x18x16 over (2,2,2): blocks of 10/9, 9/9 and 8/8 cells, each at its
    own extent in the port; the JAX package's resident uneven path is its
    serialized one (exchange, then the three stages) whatever ``overlap``
    says, and so is the port's. Owned cells within 1e-10."""
    ts, _ = specs((19, 18, 16), (2, 2, 2))
    assert not ts.is_uniform() and ts.sizes_x == (10, 9)
    got, want, init, _ = run_both((19, 18, 16), (2, 2, 2), "overlap")
    assert_close(got, want, init, np.float64)
