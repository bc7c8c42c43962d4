"""R1CS constraint system over the BN254 scalar field.

Copy of zkm_tpu/snark/r1cs.py.

The in-repo analog of gnark's frontend used by the reference's Groth16
wrapper (recursion/src/snark/libsnark/snark_prover.go:45-309 loads a BN254
R1CS and proves it).  Circuits synthesize with concrete witness values
(wrap-time synthesis — the claim is known when wrapping), recording sparse
(A, B, C) rows meaning <A,w> * <B,w> = <C,w>.

Wire 0 is the constant 1; public wires come first (Groth16's IC layout and
the Solidity verifier's input ordering depend on this).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .bn254 import R as FR

LinComb = Dict[int, int]   # wire index -> coefficient (mod FR)


class R1CS:
    def __init__(self):
        self.values: List[int] = [1]          # wire 0 = 1
        self.num_public = 0                    # wires 1..num_public
        self.constraints: List[Tuple[LinComb, LinComb, LinComb]] = []

    # -- wires ---------------------------------------------------------------

    def alloc(self, value: int, public: bool = False) -> int:
        """New wire with concrete value.  Public wires must all be
        allocated before any private wire."""
        idx = len(self.values)
        self.values.append(value % FR)
        if public:
            assert idx == self.num_public + 1, \
                "public wires must be allocated first"
            self.num_public += 1
        return idx

    def val(self, wire: int) -> int:
        return self.values[wire]

    # -- constraints -----------------------------------------------------------

    def constrain(self, a: LinComb, b: LinComb, c: LinComb):
        self.constraints.append((a, b, c))

    def lc(self, *terms) -> LinComb:
        """Linear combination of (wire, coeff) terms."""
        out: LinComb = {}
        for w, coeff in terms:
            out[w] = (out.get(w, 0) + coeff) % FR
        return out

    def _eval(self, lc: LinComb) -> int:
        return sum(coeff * self.values[w] for w, coeff in lc.items()) % FR

    # -- gadgets ---------------------------------------------------------------

    def mul(self, x: int, y: int) -> int:
        z = self.alloc(self.values[x] * self.values[y])
        self.constrain({x: 1}, {y: 1}, {z: 1})
        return z

    def add_lc(self, terms, const: int = 0) -> int:
        """Wire pinned equal to a linear combination (1 constraint)."""
        lc = self.lc(*terms)
        if const:
            lc[0] = (lc.get(0, 0) + const) % FR
        z = self.alloc(self._eval(lc))
        self.constrain(lc, {0: 1}, {z: 1})
        return z

    def assert_eq(self, x: int, y: int):
        self.constrain({x: 1}, {0: 1}, {y: 1})

    def pow7(self, x: int) -> int:
        x2 = self.mul(x, x)
        x4 = self.mul(x2, x2)
        x6 = self.mul(x4, x2)
        return self.mul(x6, x)

    def bits(self, x: int, width: int) -> List[int]:
        """Bit-decompose wire x (width bits, little-endian); binds the
        recomposition and booleanity (width+1 constraints)."""
        v = self.values[x]
        assert v < (1 << width), "value exceeds declared bit width"
        bs = []
        for i in range(width):
            b = self.alloc((v >> i) & 1)
            self.constrain({b: 1}, {b: 1, 0: FR - 1}, {})   # b*(b-1) = 0
            bs.append(b)
        self.constrain(self.lc(*[(b, 1 << i) for i, b in enumerate(bs)]),
                       {0: 1}, {x: 1})
        return bs

    # -- checks ------------------------------------------------------------------

    def is_satisfied(self) -> bool:
        for a, b, c in self.constraints:
            if (self._eval(a) * self._eval(b) - self._eval(c)) % FR:
                return False
        return True

    @property
    def num_wires(self) -> int:
        return len(self.values)
