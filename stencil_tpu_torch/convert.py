"""Carry grid state between the JAX package and the port.

This system has no weights: its state is the grid. Both packages keep each
quantity as a stacked ``(bz, by, bx, pz, py, px)`` array of halo-padded
blocks with the same padding (``GridSpec(aligned=True)``), so state moves
across as a plain copy that keeps each array's dtype: :func:`state_from_jax`
takes the JAX package's arrays (as numpy, e.g. ``np.asarray(jax_array)``),
whether jacobi3d's temperature and int32 ``sel`` or Astaroth's 8-field dict
(``lnrho``, ``uux`` ... ``entropy``) in fp32 or fp64, and
:func:`state_to_numpy` gives numpy arrays the JAX package's
``jax.device_put`` takes back. A campaign slot's ``(B, pz, py, px)``
tenant stack moves the same way, and tenant snapshots are the second
carrier: either package restores the other's (``ckpt/``).

On a mesh of block positions the port keeps one ``(1, 1, 1, pz, py, px)``
block per position where the JAX package shards one stacked array over its
device mesh: :func:`mesh_state_from_jax` splits the JAX package's sharded
arrays (as numpy) into the mesh's blocks, and :func:`mesh_state_to_numpy`
joins them back. :func:`block_from_jax` carries a JAX ``LocalBlock`` (one
subdomain's double-buffered quantities) across as the port's.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .domain import GridSpec, LocalBlock
from .geometry import DIRECTIONS_26, Radius
from .parallel.exchange import join_positions, split_positions


def state_from_jax(arrays: Mapping, spec: GridSpec, device) -> Dict:
    """``{key: tensor on device}`` from ``{key: numpy array}`` in the JAX
    package's stacked padded layout (quantities and ``sel`` alike); the
    shape must be ``spec.stacked_shape_zyx()`` or, for a one-block spec, a
    campaign slot's ``(B, pz, py, px)`` stack of tenants."""
    want = spec.stacked_shape_zyx()
    out = {}
    for key, a in arrays.items():
        a = np.asarray(a)
        tenants = spec.num_blocks() == 1 and a.ndim == 4 and a.shape[1:] == want[3:]
        if a.shape != want and not tenants:
            raise ValueError(f"{key!r}: shape {a.shape}, expected {want} or (B, *{want[3:]})")
        # a copy: arrays from JAX are read-only
        out[key] = torch.from_numpy(np.array(a, order="C")).to(device)
    return out


def state_to_numpy(tensors: Mapping) -> Dict:
    """``{key: numpy array}`` of port tensors, in the same layout."""
    return {key: t.detach().cpu().numpy() for key, t in tensors.items()}


def mesh_state_from_jax(arrays: Mapping, spec: GridSpec, mesh) -> Dict:
    """``{key: [block per position]}`` on ``mesh`` (a ``DeviceMesh`` whose
    shape is ``spec``'s partition) from ``{key: numpy array}`` in the JAX
    package's stacked layout ``spec.stacked_shape_zyx()``, e.g.
    ``np.asarray`` of an array sharded over its device mesh."""
    want = spec.stacked_shape_zyx()
    out = {}
    for key, a in arrays.items():
        a = np.asarray(a)
        if a.shape != want:
            raise ValueError(f"{key!r}: shape {a.shape}, expected {want}")
        out[key] = split_positions(torch.from_numpy(np.array(a, order="C")), spec, mesh)
    return out


def mesh_state_to_numpy(state: Mapping, spec: GridSpec) -> Dict:
    """``{key: numpy array}`` in the stacked layout from a mesh state
    ``{key: [block per position]}``."""
    return {key: join_positions(blocks, spec).detach().cpu().numpy()
            for key, blocks in state.items()}


def block_from_jax(jblock, device) -> LocalBlock:
    """The port's ``LocalBlock`` on ``device`` holding a copy of the JAX
    package's block ``jblock``: the same size, origin, radius (direction by
    direction), quantities (names and dtypes, in order) and curr and next
    arrays."""
    r = Radius.constant(0)
    for d in DIRECTIONS_26:
        r.set_dir(d, jblock.radius.dir(d.x, d.y, d.z))
    b = LocalBlock(tuple(jblock.size.as_tuple()), tuple(jblock.origin.as_tuple()), r, device)
    handles = [b.add_data(h.name, h.dtype) for h in jblock.handles()]
    if jblock._realized:
        b.realize()
        for h, jh in zip(handles, jblock.handles()):
            b.set_curr(h, torch.from_numpy(np.array(jblock.get_curr(jh))))
            b.set_next(h, torch.from_numpy(np.array(jblock.get_next(jh))))
    return b
