"""Small integer helpers used by the partitioners.

The port's own copy of the parts of ``stencil_tpu.geometry.numeric`` it
needs (reference: include/stencil/numeric.hpp, src/numeric.cpp). Pure
host-side integer math used at plan time.
"""

from __future__ import annotations


def prime_factors(n: int) -> list[int]:
    """Prime factorization of ``n``, sorted largest-first.

    The largest-first order matters: the partitioners split the domain by one
    prime factor at a time, and splitting by the biggest factor first yields
    the reference's exact subdomain shapes (reference: src/numeric.cpp:7-26).
    """
    if n < 1:
        raise ValueError(f"prime_factors requires n >= 1, got {n}")
    factors: list[int] = []
    remaining = n
    p = 2
    while p * p <= remaining:
        while remaining % p == 0:
            factors.append(p)
            remaining //= p
        p += 1
    if remaining > 1:
        factors.append(remaining)
    factors.sort(reverse=True)
    return factors


def div_ceil(n: int, d: int) -> int:
    """Ceiling division (reference: include/stencil/numeric.hpp:25)."""
    return -(-n // d)
