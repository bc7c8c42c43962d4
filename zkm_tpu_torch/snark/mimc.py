"""MiMC-7 hash over the BN254 scalar field (in-circuit friendly).

Copy of zkm_tpu/snark/mimc.py (the same round constants).

The reference's wrap pipeline compresses the block proof's public inputs
into SNARK-field digests inside the wrapper circuit (plonky2x WrappedCircuit
hashes public inputs before the gnark stage; recursion/src/lib.rs:119-133).
This is the analogous in-circuit hash for our wrap: the MiMC block cipher
with x^7 round function (91 rounds, exponent 7 is a permutation of Fr) in
Miyaguchi–Preneel mode, the same construction as circomlib's MiMC7.
Round constants are nothing-up-my-sleeve: a SHA-256 chain seeded with
b"zkm-tpu-mimc-bn254" (c_0 = 0 as usual so the first round adds only the
key).
"""

from __future__ import annotations

import hashlib
from typing import List

from .bn254 import R as FR
from .r1cs import R1CS

N_ROUNDS = 91


def _round_constants() -> List[int]:
    cts = [0]
    h = b"zkm-tpu-mimc-bn254"
    for _ in range(N_ROUNDS - 1):
        h = hashlib.sha256(h).digest()
        cts.append(int.from_bytes(h, "big") % FR)
    return cts


CTS = _round_constants()


def mimc7(x: int, k: int) -> int:
    """One MiMC-7 encryption E_k(x) (host)."""
    t = x % FR
    for c in CTS:
        t = pow((t + k + c) % FR, 7, FR)
    return (t + k) % FR


def hash_elements(elements: List[int]) -> int:
    """Miyaguchi–Preneel over the element sequence (host)."""
    h = 0
    for m in elements:
        m = m % FR
        h = (mimc7(m, h) + h + m) % FR
    return h


def mimc7_circuit(cs: R1CS, x: int, k: int) -> int:
    """E_k(x) in-circuit; x, k are wire indices.  4 constraints/round."""
    t = x
    for i, c in enumerate(CTS):
        # u = t + k + c (linear, folded into the pow7 input constraint)
        u = cs.add_lc([(t, 1), (k, 1)], const=c)
        t = cs.pow7(u)
    return cs.add_lc([(t, 1), (k, 1)])


def hash_elements_circuit(cs: R1CS, element_wires: List[int]) -> int:
    h = cs.add_lc([], const=0)     # wire pinned to 0
    for m in element_wires:
        e = mimc7_circuit(cs, m, h)
        h = cs.add_lc([(e, 1), (h, 1), (m, 1)])
    return h
