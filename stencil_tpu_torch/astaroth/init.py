"""Field initializers for the Astaroth workload, vectorized on host.

The port's own copy of ``stencil_tpu.astaroth.init`` (numpy only, so the
same size gives the same arrays in both packages), a re-implementation of
the reference's init kernels
(reference: astaroth/astaroth.cu:20-245): hash-random (splitmix64-style
avalanche per coordinate), constant, sine wave, and the radial-explosion
velocity shell. All produce global [z, y, x] numpy arrays to be scattered
with ``shard_blocks``; values are bit-deterministic functions of the global
coordinate, so any partition yields the same field.
"""

from __future__ import annotations

import numpy as np

from ..geometry import Dim3


def _hash64(x: np.ndarray) -> np.ndarray:
    """splitmix64-style avalanche (reference: astaroth.cu:84-89)."""
    x = x.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def hash_init(global_size, dtype=np.float64) -> np.ndarray:
    """'Bad' deterministic random in [-1, 1] from hashed coordinates
    (reference: astaroth.cu:92-114)."""
    g = Dim3.of(global_size)
    z, y, x = np.meshgrid(
        np.arange(g.z, dtype=np.uint64),
        np.arange(g.y, dtype=np.uint64),
        np.arange(g.x, dtype=np.uint64),
        indexing="ij",
        sparse=True,
    )
    h = _hash64(x) ^ _hash64(y) ^ _hash64(z)
    # float32 quotient then double shift, like the reference's T=double path
    val = (h.astype(np.float32) / np.float32(np.uint64(0xFFFFFFFFFFFFFFFF))).astype(
        np.float64
    )
    return ((val - 0.5) * 2).astype(dtype)


def const_init(global_size, value, dtype=np.float64) -> np.ndarray:
    """(reference: astaroth.cu:117-133)"""
    g = Dim3.of(global_size)
    return np.full((g.z, g.y, g.x), value, dtype=dtype)


def sin_init(global_size, ampl=0.0001, period=16, dtype=np.float64) -> np.ndarray:
    """Sine wave along y (reference: astaroth.cu:53-75)."""
    g = Dim3.of(global_size)
    y = np.arange(g.y, dtype=dtype)
    val = ampl * np.sin(y.astype(np.float32) * 2 * np.pi / period)
    return np.broadcast_to(val[None, :, None], (g.z, g.y, g.x)).astype(dtype)


def radial_explosion_init(
    global_size,
    ds=(0.04908738521,) * 3,
    ampl_uu=1.0,
    shell_radius=0.8,
    width=0.2,
    origin=None,
    dtype=np.float64,
):
    """Gaussian velocity shell pointing radially outward; returns
    (uux, uuy, uuz) global arrays (reference: astaroth.cu:136-245).

    The reference computes spherical angles with quadrant case analysis and
    then converts back; the same result comes directly from the unit radial
    vector: uu_i = uu_radial * (r_i / |r|).
    """
    g = Dim3.of(global_size)
    dsx, dsy, dsz = ds
    if origin is None:
        origin = (0.01, 32 * dsy, 50 * dsz)  # reference: astaroth.cu:150
    z, y, x = np.meshgrid(
        np.arange(g.z, dtype=dtype),
        np.arange(g.y, dtype=dtype),
        np.arange(g.x, dtype=dtype),
        indexing="ij",
        sparse=True,
    )
    xx = x * dsx - origin[0]
    yy = y * dsy - origin[1]
    zz = z * dsz - origin[2]
    rr = np.sqrt(xx**2 + yy**2 + zz**2)
    uu_radial = ampl_uu * np.exp(-((rr - shell_radius) ** 2) / (2.0 * width**2))
    with np.errstate(invalid="ignore", divide="ignore"):
        inv_rr = np.where(rr > 0, 1.0 / np.where(rr > 0, rr, 1.0), 0.0)
    uu_radial = np.where(rr > 0, uu_radial, 0.0)
    uux = (uu_radial * xx * inv_rr).astype(dtype)
    uuy = (uu_radial * yy * inv_rr).astype(dtype)
    uuz = (uu_radial * zz * inv_rr).astype(dtype)
    return uux, uuy, uuz
