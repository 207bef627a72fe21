"""Astaroth over resident blocks, the port against the JAX package on one
CPU device: the step on (2, 1, 1) with overlap on and off, and the hoisted
order against the serialized one (helpers and tolerances:
``test_torch_astaroth_resident.py``)."""

import pytest
import torch

from test_torch_astaroth_resident import overlap_matches_serial, step_matches_jax

torch.set_num_threads(2)


@pytest.mark.parametrize("mode", ["overlap", "serial"])
def test_step_matches_jax(mode):
    step_matches_jax((2, 1, 1), mode)


def test_overlap_matches_serial():
    overlap_matches_serial((2, 1, 1))
