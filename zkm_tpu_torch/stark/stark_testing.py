"""Per-STARK testing harnesses.

Counterpart of zkm_tpu/stark/stark_testing.py (zkMIPS
prover/src/stark_testing.rs): `check_stark_low_degree` evaluates a
table's constraints on the low-degree extension of a *random* trace and
checks the composed constraint polynomial stays within the declared
degree bound (catching accidental degree-4+ constraints, wrong selector
usage, etc.).  The constraints run through `expr.evaluate_ir`, node by
node, on the port's field arithmetic and NTT.
"""

from __future__ import annotations

import numpy as np
import torch

from ..convert import from_u64, to_u64
from ..device import resolve_device
from ..field import goldilocks as gl
from ..field import ntt
from . import expr

P = gl.P


def check_stark_low_degree(stark, degree_bits: int = 3, seed: int = 0,
                           device=None):
    """Raises AssertionError if any composed constraint exceeds degree
    3*(n-1) + n (constraint degree x trace degree plus one selector).
    Runs on the card unless device='cpu'."""
    device = resolve_device(device)
    n = 1 << degree_bits
    rate_bits = 3
    m = n << rate_bits
    rng = np.random.default_rng(seed)
    values = from_u64(rng.integers(0, P, size=(stark.num_columns, n),
                                   dtype=np.uint64), device)
    lde = ntt.lde(ntt.intt(values), rate_bits)   # coset g*H_m, natural order
    nxt = torch.roll(lde, -(1 << rate_bits), dims=-1)

    # polynomial selectors evaluated over the coset
    xs = gl.mul(gl.powers(gl.primitive_root_of_unity(degree_bits + rate_bits),
                          m, device), gl.GENERATOR)
    g_last = gl.host_pow(gl.primitive_root_of_unity(degree_bits), n - 1)
    zh = gl.sub(gl.pow_const(xs, n), 1)           # Z_H(x) = x^n - 1
    n_inv = gl.host_inv(n)
    selectors = {
        expr.SymConsumer.ALL: None,
        expr.SymConsumer.TRANSITION: gl.sub(xs, g_last),
        expr.SymConsumer.FIRST: gl.mul(gl.mul(zh, n_inv),
                                       gl.inverse(gl.sub(xs, 1))),
        expr.SymConsumer.LAST: gl.mul(gl.mul(zh, (n_inv * g_last) % P),
                                      gl.inverse(gl.sub(xs, g_last))),
    }
    publics = [int(v) for v in rng.integers(
        0, P, size=stark.num_public_inputs, dtype=np.uint64)]

    alphas = (3, 5)
    accs = [gl.zeros((m,), device) for _ in alphas]

    def consume(kind, value):
        if not isinstance(value, torch.Tensor):
            value = gl.full((m,), value, device)
        sel = selectors[kind]
        if sel is not None:
            value = gl.mul(value, sel)
        for j, alpha in enumerate(alphas):
            accs[j] = gl.add(gl.mul(accs[j], alpha), value)

    expr.evaluate_ir(expr.compile_stark(stark), lambda c: lde[c],
                     lambda c: nxt[c], consume, publics)

    max_degree = 3 * (n - 1) + n
    for k, acc in enumerate(accs):
        coeffs = to_u64(ntt.coset_intt(acc.reshape(1, m)))[0]
        high = np.nonzero(coeffs)[0]
        deg = int(high[-1]) if high.size else 0
        assert deg <= max_degree, \
            f"constraint accumulator {k} has degree {deg} > {max_degree}"
