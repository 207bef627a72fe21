"""The ParaView CSV rows of one block: ``Z,Y,X,<quantity names>`` per
interior cell (reference: src/stencil.cu:1188-1264).

:func:`write` streams the rows from the C++ writer
(``csrc_host/paraview.cpp``, built by ``ops/_native.build_host`` on first
use; a failed build raises). :func:`write_plain` is its plain version, the
JAX package's Python row loop (``stencil_tpu/api.py:890-899``): the tests
hold the two byte for byte, and nothing on the main path calls it.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import numpy as np

_DP = ctypes.POINTER(ctypes.c_double)


def _writer():
    from ..ops import _native

    lib = _native.build_host("paraview")
    fn = lib.stencil_paraview_write
    fn.argtypes = [ctypes.c_char_p, ctypes.c_char_p] + [ctypes.c_int64] * 6 + [
        ctypes.c_int, ctypes.POINTER(_DP)]
    fn.restype = ctypes.c_int
    return fn


def write(path: str, header: str, origin, size, qs: Sequence[np.ndarray]) -> None:
    """One block's rows from the C++ writer. ``origin`` and ``size`` are
    (z, y, x) tuples, ``qs`` the block's interior per quantity, each a
    ``[sz, sy, sx]`` array (written as float64, which every cell of a
    float32 or float64 field is exactly)."""
    arrs = [np.ascontiguousarray(q, dtype=np.float64) for q in qs]
    ptrs = (_DP * len(arrs))(*[a.ctypes.data_as(_DP) for a in arrs])
    rc = _writer()(path.encode(), header.encode(),
                   int(origin[0]), int(origin[1]), int(origin[2]),
                   int(size[0]), int(size[1]), int(size[2]), len(arrs), ptrs)
    if rc != 0:
        raise OSError(f"stencil_paraview_write({path!r}) failed rc={rc}")


def write_plain(path: str, header: str, origin, size, qs: Sequence[np.ndarray]) -> None:
    """:func:`write`'s plain version: the JAX package's row loop."""
    oz, oy, ox = (int(v) for v in origin)
    sz, sy, sx = (int(v) for v in size)
    with open(path, "w") as f:
        f.write(header + "\n")
        for lz in range(sz):
            for ly in range(sy):
                for lx in range(sx):
                    row = [str(oz + lz), str(oy + ly), str(ox + lx)]
                    row += [repr(float(q[lz, ly, lx])) for q in qs]
                    f.write(",".join(row) + "\n")
