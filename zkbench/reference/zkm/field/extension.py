# Frozen copy of zkm_tpu_torch/field/extension.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
"""Quadratic extension GF(p^2) = GF(p)[X]/(X^2 - 7).

Counterpart of `zkm_tpu/field/extension.py`.  An extension element is a
pair ``(c0, c1)`` of base-field int64 tensors meaning c0 + c1*X; host
scalars are ``(int, int)`` tuples.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import goldilocks as gl

Gf2 = Tuple[torch.Tensor, torch.Tensor]

W = gl.EXT_W


def add(a: Gf2, b: Gf2) -> Gf2:
    return gl.add(a[0], b[0]), gl.add(a[1], b[1])


def sub(a: Gf2, b: Gf2) -> Gf2:
    return gl.sub(a[0], b[0]), gl.sub(a[1], b[1])


def mul(a: Gf2, b: Gf2) -> Gf2:
    c0 = gl.add(gl.mul(a[0], b[0]), gl.mul(gl.mul(a[1], b[1]), W))
    c1 = gl.add(gl.mul(a[0], b[1]), gl.mul(a[1], b[0]))
    return c0, c1


# frozen: left out, as only the prover uses them: mul_base.


def inverse(a: Gf2) -> Gf2:
    """1/(c0 + c1 X) = (c0 - c1 X) / (c0^2 - W c1^2)."""
    norm = gl.sub(gl.square(a[0]), gl.mul(gl.square(a[1]), W))
    ninv = gl.inverse(norm)
    return gl.mul(a[0], ninv), gl.neg(gl.mul(a[1], ninv))


def sum_axis(a: Gf2, axis: int) -> Gf2:
    return gl.sum_axis(a[0], axis), gl.sum_axis(a[1], axis)


# Host-side scalar model (python ints): element = (int, int)

def host_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 + W * a1 * b1) % gl.P, (a0 * b1 + a1 * b0) % gl.P)


def host_inv(a):
    a0, a1 = a
    norm = (a0 * a0 - W * a1 * a1) % gl.P
    ninv = gl.host_inv(norm)
    return ((a0 * ninv) % gl.P, (-a1 * ninv) % gl.P)


def host_pow(a, e: int):
    result = (1, 0)
    base = a
    while e:
        if e & 1:
            result = host_mul(result, base)
        e >>= 1
        base = host_mul(base, base)
    return result
