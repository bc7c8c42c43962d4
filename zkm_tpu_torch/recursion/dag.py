"""Arithmetic-DAG recorder for the recursive (shrink) verifier.

Copy of zkm_tpu/recursion/dag.py (analog of plonky2's `CircuitBuilder` as
zkMIPS uses it in prover/src/recursive_verifier.rs:203-307).  Instead of a
gate/wire circuit, the design records the *verifier itself* as a
flat operation DAG over Goldilocks wires (docs/recursion.md, stage R1): the
native verifier code re-runs over symbolic `Wire` values and every
arithmetic step, Poseidon permutation, witness hint, and assertion is
appended to a program list.  The recorded DAG is a fixed dataflow for a
fixed proof *shape* — it can be

  * replayed on a concrete proof (`evaluate`) — the equivalence test
    against the native verifier, and the witness generator for stage R2;
  * lowered to the uniform Verifier-table trace (one row per op, wire
    values bound by a logUp wire-memory, Poseidon macros via CTL into the
    existing Poseidon table).

Wire ids are `Wire` (an int subclass) so algebra code can distinguish
symbolic values from protocol constants.  Ops are constant-folded and
hash-consed (common-subexpression eliminated) at record time.

Soundness note on `bits()`: the 64-bit decomposition of a field element is
asserted to recompose mod p, which admits the non-canonical x+p encoding
for x < 2^32-1 (same as plonky2's `split_le` used for FRI query indices /
PoW): the high 32 bits of the alternative are all ones, so a PoW check can
only be *harder* to satisfy non-canonically, and for query indices the
prover gains at most one bit of grinding — accepted by the reference
protocol as well.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

from ..field import goldilocks as gl
from ..hash import poseidon as ps

P = gl.P


class Wire(int):
    """A DAG wire id.  Subclasses int so it can index lists and key dicts;
    algebra code uses isinstance(x, Wire) to tell wires from constants."""
    __slots__ = ()


class Dag:
    __slots__ = ("prog", "n", "cse", "cval", "pub", "asserts",
                 "num_poseidons", "zero", "one")

    def __init__(self):
        self.prog: List[tuple] = []   # ('c',out,v) ('i',out) ('+',out,a,b)
        #                               ('-',out,a,b) ('*',out,a,b)
        #                               ('h',outs,fn,ins) ('p',outs,ins)
        self.n = 0
        self.cse = {}
        self.cval = {}                # wire -> constant value (if const)
        self.pub: List[Wire] = []     # public-input wires, in layout order
        self.asserts: List[Tuple[Wire, str]] = []
        self.num_poseidons = 0
        self.zero = self.constant(0)
        self.one = self.constant(1)

    # -- wire creation --------------------------------------------------------

    def _new(self) -> Wire:
        w = Wire(self.n)
        self.n += 1
        return w

    def constant(self, v: int) -> Wire:
        v %= P
        key = ('c', v)
        w = self.cse.get(key)
        if w is None:
            w = self._new()
            self.cse[key] = w
            self.cval[w] = v
            self.prog.append(('c', w, v))
        return w

    def pub_input(self) -> Wire:
        w = self._new()
        self.pub.append(w)
        self.prog.append(('i', w))
        return w

    def pub_inputs(self, k: int) -> List[Wire]:
        return [self.pub_input() for _ in range(k)]

    # -- arithmetic (constant-folded + hash-consed) ---------------------------

    def add(self, a: Wire, b: Wire) -> Wire:
        cv = self.cval
        va, vb = cv.get(a), cv.get(b)
        if va is not None and vb is not None:
            return self.constant(va + vb)
        if va == 0:
            return b
        if vb == 0:
            return a
        if b < a:
            a, b = b, a
        key = ('+', a, b)
        w = self.cse.get(key)
        if w is None:
            w = self._new()
            self.cse[key] = w
            self.prog.append(('+', w, a, b))
        return w

    def sub(self, a: Wire, b: Wire) -> Wire:
        cv = self.cval
        va, vb = cv.get(a), cv.get(b)
        if va is not None and vb is not None:
            return self.constant(va - vb)
        if vb == 0:
            return a
        if a == b:
            return self.zero
        key = ('-', a, b)
        w = self.cse.get(key)
        if w is None:
            w = self._new()
            self.cse[key] = w
            self.prog.append(('-', w, a, b))
        return w

    def mul(self, a: Wire, b: Wire) -> Wire:
        cv = self.cval
        va, vb = cv.get(a), cv.get(b)
        if va is not None and vb is not None:
            return self.constant(va * vb)
        if va == 1:
            return b
        if vb == 1:
            return a
        if va == 0 or vb == 0:
            return self.zero
        if b < a:
            a, b = b, a
        key = ('*', a, b)
        w = self.cse.get(key)
        if w is None:
            w = self._new()
            self.cse[key] = w
            self.prog.append(('*', w, a, b))
        return w

    def mul_const(self, a: Wire, k: int) -> Wire:
        return self.mul(a, self.constant(k))

    def add_const(self, a: Wire, k: int) -> Wire:
        return self.add(a, self.constant(k))

    # -- hints (prover-supplied witness wires) --------------------------------

    def hint(self, ins: Sequence[Wire], n_out: int,
             fn: Callable[[List[int]], List[int]]) -> List[Wire]:
        """n_out fresh wires computed from resolved `ins` at replay time.
        Hints carry NO soundness: the caller must pin them by assertions."""
        outs = [self._new() for _ in range(n_out)]
        self.prog.append(('h', tuple(outs), fn, tuple(ins)))
        return outs

    def poseidon(self, ins: Sequence[Wire]) -> List[Wire]:
        """Poseidon width-12 permutation macro node (one CTL row in R2)."""
        ins = tuple(ins)
        assert len(ins) == 12
        key = ('p', ins)
        cached = self.cse.get(key)
        if cached is not None:
            return list(cached)
        outs = tuple(self._new() for _ in range(12))
        self.cse[key] = outs
        self.prog.append(('p', outs, ins))
        self.num_poseidons += 1
        return list(outs)

    # -- assertions ------------------------------------------------------------

    def assert_zero(self, w: Wire, label: str = ""):
        v = self.cval.get(w)
        if v is not None:
            if v != 0:
                raise ValueError(
                    f"assertion statically false at record time: {label}")
            return
        self.asserts.append((w, label))

    def assert_eq(self, a: Wire, b: Wire, label: str = ""):
        self.assert_zero(self.sub(a, b), label)

    # -- derived gadgets -------------------------------------------------------

    def select(self, b: Wire, x: Wire, y: Wire) -> Wire:
        """b ? x : y  (b must be 0/1 — callers assert booleanity once)."""
        return self.add(y, self.mul(b, self.sub(x, y)))

    def select_vec(self, b: Wire, xs: Sequence[Wire],
                   ys: Sequence[Wire]) -> List[Wire]:
        return [self.select(b, x, y) for x, y in zip(xs, ys)]

    def mux(self, bits: Sequence[Wire], items: Sequence) -> object:
        """items[index] with index = sum bits[k] 2^k; items are wires or
        equal-length wire lists.  Balanced select tree (len(bits) levels)."""
        items = list(items)
        assert len(items) == 1 << len(bits)
        vec = isinstance(items[0], (list, tuple))
        for b in bits:
            half = len(items) // 2
            if vec:
                items = [self.select_vec(b, items[2 * i + 1], items[2 * i])
                         for i in range(half)]
            else:
                items = [self.select(b, items[2 * i + 1], items[2 * i])
                         for i in range(half)]
        return items[0]

    def inverse(self, x: Wire, label: str = "inverse") -> Wire:
        (xi,) = self.hint((x,), 1, _hint_inverse)
        self.assert_zero(self.sub(self.mul(x, xi), self.one), label)
        return xi

    def bits(self, x: Wire, nbits: int = 64, label: str = "bits") -> List[Wire]:
        """LE bit decomposition (see module docstring for canonicity)."""
        bs = self.hint((x,), nbits, _make_hint_bits(nbits))
        acc = self.zero
        for k, b in enumerate(bs):
            self.assert_zero(self.mul(b, self.sub(b, self.one)),
                             f"{label}:bool{k}")
            acc = self.add(acc, self.mul_const(b, 1 << k))
        self.assert_eq(acc, x, f"{label}:recompose")
        return bs

    # -- stats ------------------------------------------------------------------

    def stats(self) -> dict:
        counts = {}
        for e in self.prog:
            counts[e[0]] = counts.get(e[0], 0) + 1
        return {"wires": self.n, "pub_inputs": len(self.pub),
                "asserts": len(self.asserts),
                "poseidons": self.num_poseidons, "ops": counts}


def _hint_inverse(vals: List[int]) -> List[int]:
    return [gl.host_inv(vals[0])]


class _HintBits:
    """Bit-decomposition hint; a picklable class (not a closure) so
    recorded DAGs serialize to the circuit cache (recursion/cache.py)."""
    __slots__ = ("nbits",)

    def __init__(self, nbits: int):
        self.nbits = nbits

    def __call__(self, vals: List[int]) -> List[int]:
        x = vals[0]
        return [(x >> k) & 1 for k in range(self.nbits)]

    def __eq__(self, other):
        return type(other) is _HintBits and other.nbits == self.nbits

    def __hash__(self):
        return hash(("_HintBits", self.nbits))


def _make_hint_bits(nbits: int):
    return _HintBits(nbits)


class ReplayFailure(ValueError):
    def __init__(self, failures):
        self.failures = failures
        preview = "; ".join(lbl for _, lbl in failures[:5])
        super().__init__(
            f"{len(failures)} DAG assertion(s) failed: {preview}")


def evaluate(dag: Dag, pub_values: Sequence[int], check: bool = True
             ) -> List[int]:
    """Replay the DAG on concrete public inputs.  Returns the full wire
    value vector; raises ReplayFailure listing failed assertion labels."""
    if len(pub_values) != len(dag.pub):
        raise ValueError(
            f"expected {len(dag.pub)} public inputs, got {len(pub_values)}")
    vals = [0] * dag.n
    it = iter(pub_values)
    permute = ps.permute_host
    for e in dag.prog:
        tag = e[0]
        if tag == '*':
            vals[e[1]] = vals[e[2]] * vals[e[3]] % P
        elif tag == '+':
            vals[e[1]] = (vals[e[2]] + vals[e[3]]) % P
        elif tag == '-':
            vals[e[1]] = (vals[e[2]] - vals[e[3]]) % P
        elif tag == 'c':
            vals[e[1]] = e[2]
        elif tag == 'i':
            vals[e[1]] = int(next(it)) % P
        elif tag == 'h':
            outs, fn, ins = e[1], e[2], e[3]
            res = fn([vals[i] for i in ins])
            for w, v in zip(outs, res):
                vals[w] = int(v) % P
        else:  # 'p'
            out = permute([vals[i] for i in e[2]])
            for w, v in zip(e[1], out):
                vals[w] = v
    if check:
        failures = [(w, lbl) for w, lbl in dag.asserts if vals[w] != 0]
        if failures:
            raise ReplayFailure(failures)
    return vals
