"""6th-order centered finite differences over halo-padded blocks.

The port's counterpart of ``stencil_tpu.astaroth.fd`` (reference:
astaroth/user_kernels.h:36-127 — first/second/cross derivative pencils of
STENCIL_ORDER 6). Each derivative is a sum of shifted slices over a whole
region; the functions are pure slicing and arithmetic, so they run on
torch tensors (and numpy arrays) unchanged. This is the plain version's
math; the CUDA substep kernel (``csrc/astaroth_substep.cu``) evaluates the
same pencils per cell, term by term in this order.

All functions take the full padded block (leading dims allowed, data dims
``[z, y, x]`` with >= 3 cells of halo) and a ``Rect3`` in allocation-local
coordinates selecting the cells to produce.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from ..geometry import Rect3

# centered-difference coefficients (reference: user_kernels.h:38-66)
FIRST_COEFFS = (3.0 / 4.0, -3.0 / 20.0, 1.0 / 60.0)
SECOND_CENTER = -49.0 / 18.0
SECOND_COEFFS = (3.0 / 2.0, -3.0 / 20.0, 1.0 / 90.0)
CROSS_COEFFS = (270.0 / 720.0, -27.0 / 720.0, 2.0 / 720.0)


def _sh(arr, rect: Rect3, dz: int, dy: int, dx: int):
    return arr[
        ...,
        slice(rect.lo.z + dz, rect.hi.z + dz),
        slice(rect.lo.y + dy, rect.hi.y + dy),
        slice(rect.lo.x + dx, rect.hi.x + dx),
    ]


def _first(arr, rect, axis_shift, inv_ds):
    """axis_shift(i) -> (dz, dy, dx) for offset i along the axis."""
    res = 0.0
    for i, c in enumerate(FIRST_COEFFS, start=1):
        res = res + c * (_sh(arr, rect, *axis_shift(i)) - _sh(arr, rect, *axis_shift(-i)))
    return res * inv_ds


def _second(arr, rect, axis_shift, inv_ds):
    res = SECOND_CENTER * _sh(arr, rect, 0, 0, 0)
    for i, c in enumerate(SECOND_COEFFS, start=1):
        res = res + c * (_sh(arr, rect, *axis_shift(i)) + _sh(arr, rect, *axis_shift(-i)))
    return res * inv_ds * inv_ds


def _cross(arr, rect, shift_a, shift_b, inv_ds_a, inv_ds_b):
    """Cross derivative from the two diagonal pencils
    (reference: user_kernels.h:62-75)."""
    res = 0.0
    for i, c in enumerate(CROSS_COEFFS, start=1):
        res = res + c * (
            _sh(arr, rect, *shift_a(i))
            + _sh(arr, rect, *shift_a(-i))
            - _sh(arr, rect, *shift_b(i))
            - _sh(arr, rect, *shift_b(-i))
        )
    return res * inv_ds_a * inv_ds_b


def derx(arr, rect, inv_dsx):
    return _first(arr, rect, lambda i: (0, 0, i), inv_dsx)


def dery(arr, rect, inv_dsy):
    return _first(arr, rect, lambda i: (0, i, 0), inv_dsy)


def derz(arr, rect, inv_dsz):
    return _first(arr, rect, lambda i: (i, 0, 0), inv_dsz)


def derxx(arr, rect, inv_dsx):
    return _second(arr, rect, lambda i: (0, 0, i), inv_dsx)


def deryy(arr, rect, inv_dsy):
    return _second(arr, rect, lambda i: (0, i, 0), inv_dsy)


def derzz(arr, rect, inv_dsz):
    return _second(arr, rect, lambda i: (i, 0, 0), inv_dsz)


def derxy(arr, rect, inv_dsx, inv_dsy):
    return _cross(
        arr, rect, lambda i: (0, i, i), lambda i: (0, -i, i), inv_dsx, inv_dsy
    )


def derxz(arr, rect, inv_dsx, inv_dsz):
    return _cross(
        arr, rect, lambda i: (i, 0, i), lambda i: (-i, 0, i), inv_dsx, inv_dsz
    )


def deryz(arr, rect, inv_dsy, inv_dsz):
    return _cross(
        arr, rect, lambda i: (i, i, 0), lambda i: (-i, i, 0), inv_dsy, inv_dsz
    )


@dataclass
class FieldData:
    """value + gradient + symmetric hessian of one scalar field over a
    region (reference: user_kernels.h AcRealData / read_data)."""

    value: Any
    gx: Any
    gy: Any
    gz: Any
    hxx: Any
    hxy: Any
    hxz: Any
    hyy: Any
    hyz: Any
    hzz: Any

    @property
    def gradient(self):
        return (self.gx, self.gy, self.gz)

    def laplace(self):
        """trace of the hessian (reference: user_kernels.h:226-229)."""
        return self.hxx + self.hyy + self.hzz


def field_data(arr, rect: Rect3, inv_ds) -> FieldData:
    """Build value/gradient/hessian for one field over ``rect``.

    ``inv_ds`` is (inv_dsx, inv_dsy, inv_dsz)."""
    ix, iy, iz = inv_ds
    return FieldData(
        value=_sh(arr, rect, 0, 0, 0),
        gx=derx(arr, rect, ix),
        gy=dery(arr, rect, iy),
        gz=derz(arr, rect, iz),
        hxx=derxx(arr, rect, ix),
        hxy=derxy(arr, rect, ix, iy),
        hxz=derxz(arr, rect, ix, iz),
        hyy=deryy(arr, rect, iy),
        hyz=deryz(arr, rect, iy, iz),
        hzz=derzz(arr, rect, iz),
    )
