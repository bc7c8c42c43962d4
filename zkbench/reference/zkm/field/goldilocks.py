# Frozen copy of zkm_tpu_torch/field/goldilocks.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
"""Goldilocks field GF(p), p = 2^64 - 2^32 + 1, on int64 tensors.

Counterpart of `zkm_tpu/field/goldilocks.py`.  An element is carried as its
u64 bit pattern in an ``int64`` tensor (torch's unsigned 64-bit tensors lack
``+``, ``>>``, ``<`` and ``where``).  Arithmetic wraps modulo 2^64, which
gives the right bits; unsigned comparisons flip the sign bit first, and a
right shift is masked because ``>>`` sign-extends.

Every public function takes canonical inputs (< p) and returns canonical
outputs, so results are bit-identical to the reference, whatever the
device.  Reduction of a 128-bit product uses 2^64 == 2^32 - 1 ("EPSILON")
and 2^96 == -1 (mod p), as the reference's `_reduce128` does.
"""

from __future__ import annotations

import torch

P = (1 << 64) - (1 << 32) + 1
EPSILON = 0xFFFFFFFF          # 2^64 mod p
MASK32 = 0xFFFFFFFF

GENERATOR = 7
TWO_ADICITY = 32
POWER_OF_TWO_GENERATOR = 1753635133440165772   # 7^((p-1)/2^32), plonky2's
EXT_W = 7

_SIGN = -(1 << 63)


def to_signed(v: int) -> int:
    """Python int -> the int64 value with the same bits as (v mod p)."""
    v %= P
    return v - (1 << 64) if v >> 63 else v


_P_S = P - (1 << 64)          # p's bit pattern as an int64
_P_FLIP = _P_S ^ _SIGN


def _ult(a: torch.Tensor, b) -> torch.Tensor:
    """Unsigned a < b on u64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _shr(a: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of a u64 bit pattern."""
    return (a >> k) & ((1 << (64 - k)) - 1)


def _canonical(s: torch.Tensor) -> torch.Tensor:
    """One conditional subtraction of p (inputs < 2^64)."""
    return torch.where((s ^ _SIGN) < _P_FLIP, s, s - _P_S)


def _like(b):
    """A tensor, or a python-int constant as its signed int64 value (torch
    takes python scalars without a host-to-device copy)."""
    return b if isinstance(b, torch.Tensor) else to_signed(int(b))


# ---------------------------------------------------------------------------
# Construction.
# ---------------------------------------------------------------------------

def full(shape, value: int, device=None) -> torch.Tensor:
    return torch.full(tuple(shape) if not isinstance(shape, int) else (shape,),
                      to_signed(value), dtype=torch.int64, device=device)


def zeros(shape, device=None) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int64, device=device)


# frozen: left out, as only the prover uses them: from_ints, cumsum, powers,
# host_powers.


# ---------------------------------------------------------------------------
# Field operations (canonical in, canonical out; broadcasting).
# ---------------------------------------------------------------------------

def add(a: torch.Tensor, b) -> torch.Tensor:
    b = _like(b)
    s = a + b
    s = torch.where(_ult(s, a), s + EPSILON, s)
    return _canonical(s)


def sub(a: torch.Tensor, b) -> torch.Tensor:
    b = _like(b)
    d = a - b
    return torch.where(_ult(a, b), d - EPSILON, d)


def neg(a: torch.Tensor) -> torch.Tensor:
    return sub(torch.zeros_like(a), a)


def _reduce128(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """(hi * 2^64 + lo) mod p, canonical."""
    hi_hi = _shr(hi, 32)
    hi_lo = hi & MASK32
    t0 = lo - hi_hi
    t0 = torch.where(_ult(lo, hi_hi), t0 - EPSILON, t0)
    t1 = hi_lo * EPSILON
    t2 = t0 + t1
    t2 = torch.where(_ult(t2, t0), t2 + EPSILON, t2)
    return _canonical(t2)


def mul(a: torch.Tensor, b) -> torch.Tensor:
    b = _like(b)
    lo = a * b
    al, ah = a & MASK32, _shr(a, 32)
    bl, bh = b & MASK32, _shr(b, 32)
    ll = al * bl
    lh = al * bh
    hl = ah * bl
    mid = hl + _shr(ll, 32) + (lh & MASK32)       # < 2^64: no carry out
    hi = ah * bh + _shr(mid, 32) + _shr(lh, 32)
    return _reduce128(lo, hi)


def square(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def pow_const(a: torch.Tensor, e: int) -> torch.Tensor:
    """a^e for a python-int exponent (square and multiply)."""
    assert e >= 0
    result = torch.ones_like(a)
    base = a
    while e:
        if e & 1:
            result = mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return result


def inverse(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2); 0 maps to 0."""
    return pow_const(a, P - 2)


def _limb_sums_to_field(s_lo: torch.Tensor, s_hi: torch.Tensor):
    """(s_lo + s_hi * 2^32) mod p for exact non-negative sums < 2^63."""
    return add(_canonical(s_lo), mul(_canonical(s_hi), 1 << 32))


def sum_axis(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Modular sum along an axis: exact int64 sums of the 32-bit limbs,
    then one reduction (valid for fewer than 2^31 terms)."""
    assert a.shape[axis] < (1 << 31)
    return _limb_sums_to_field((a & MASK32).sum(dim=axis),
                               _shr(a, 32).sum(dim=axis))


# ---------------------------------------------------------------------------
# Host-side (python-int) scalar field math.
# ---------------------------------------------------------------------------

def host_mul(a: int, b: int) -> int:
    return (a * b) % P


def host_pow(a: int, e: int) -> int:
    return pow(a, e, P)


def host_inv(a: int) -> int:
    return pow(a, P - 2, P)


def primitive_root_of_unity(n_log: int) -> int:
    """2^n_log-th primitive root of unity (plonky2-compatible subgroup)."""
    assert 0 <= n_log <= TWO_ADICITY
    root = POWER_OF_TWO_GENERATOR
    for _ in range(TWO_ADICITY - n_log):
        root = (root * root) % P
    return root

