"""BN254 (alt_bn128) curve + optimal-ate pairing, pure Python.

Copy of zkm_tpu/snark/bn254.py (the reference has no kernel here: plain
Python ints, on the host).

The reference performs its on-chain wrap through Go gnark over this same
curve (recursion/src/snark/libsnark/snark_prover.go:45-309 builds a BN254
R1CS and runs Groth16).  This module is the in-repo equivalent of gnark's
curve layer: Fp / Fp2 / Fp12 towers, G1/G2 group law, and the ate pairing
used by Groth16 setup/prove/verify (groth16.py) and the emitted Solidity
verifier (contract.py) — which targets the EVM's bn128 precompiles over
the identical parameters.

Performance is irrelevant at this layer (one wrap per block; the reference
shells out to Go for the same reason), so everything is plain Python ints.
Field towers follow the standard construction (the same one py_ecc/gnark
use): Fp2 = Fp[u]/(u^2+1), Fp12 = Fp[w]/(w^12 - 18 w^6 + 82), with the
sextic twist mapping G2 into Fp12.
"""

from __future__ import annotations

# Curve order and base field modulus (EIP-196/197 parameters).
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

ATE_LOOP_COUNT = 29793968203157093288
LOG_ATE_LOOP_COUNT = 63


# -- field towers -------------------------------------------------------------


class FQ:
    """Fp element."""
    __slots__ = ("n",)
    degree = 1

    def __init__(self, n: int):
        self.n = n % P

    def __add__(self, o): return FQ(self.n + _val(o))
    __radd__ = __add__

    def __sub__(self, o): return FQ(self.n - _val(o))

    def __rsub__(self, o): return FQ(_val(o) - self.n)

    def __mul__(self, o): return FQ(self.n * _val(o))
    __rmul__ = __mul__

    def __neg__(self): return FQ(-self.n)

    def inv(self): return FQ(pow(self.n, P - 2, P))

    def __truediv__(self, o):
        o = o if isinstance(o, FQ) else FQ(_val(o))
        return self * o.inv()

    def __pow__(self, e: int):
        return FQ(pow(self.n, e, P))

    def __eq__(self, o):
        return self.n == (o.n if isinstance(o, FQ) else _val(o) % P)

    def __hash__(self): return hash(("FQ", self.n))

    def __repr__(self): return f"FQ({self.n})"

    @classmethod
    def one(cls): return FQ(1)

    @classmethod
    def zero(cls): return FQ(0)


def _val(o):
    if isinstance(o, FQ):
        return o.n
    if isinstance(o, int):
        return o
    raise TypeError(type(o))


class FQP:
    """Fp[x]/modulus polynomial extension (coefficients low->high)."""
    degree = 0            # overridden
    mod_coeffs = ()       # modulus = x^degree - sum(mod_coeffs[i] x^i)

    def __init__(self, coeffs):
        assert len(coeffs) == self.degree
        self.coeffs = [c % P for c in coeffs]

    def __add__(self, o):
        return type(self)([a + b for a, b in zip(self.coeffs, o.coeffs)])

    def __sub__(self, o):
        return type(self)([a - b for a, b in zip(self.coeffs, o.coeffs)])

    def __neg__(self):
        return type(self)([-a for a in self.coeffs])

    def __mul__(self, o):
        if isinstance(o, int):
            return type(self)([c * o for c in self.coeffs])
        if isinstance(o, FQ):
            return type(self)([c * o.n for c in self.coeffs])
        d = self.degree
        prod = [0] * (2 * d - 1)
        for i, a in enumerate(self.coeffs):
            if a:
                for j, b in enumerate(o.coeffs):
                    prod[i + j] += a * b
        # reduce by x^d = mod_coeffs
        for i in range(2 * d - 2, d - 1, -1):
            top = prod[i]
            if top:
                prod[i] = 0
                for j, mc in self.mod_sparse:
                    prod[i - d + j] += top * mc
        return type(self)([c % P for c in prod[:d]])
    __rmul__ = __mul__

    def __pow__(self, e: int):
        result = type(self).one()
        base = self
        while e:
            if e & 1:
                result = result * base
            base = base * base
            e >>= 1
        return result

    def inv(self):
        """Extended Euclid over Fp[x]."""
        d = self.degree
        lm, hm = [1] + [0] * d, [0] * (d + 1)
        low = list(self.coeffs) + [0]
        # monic modulus polynomial: x^d + mod_full (low coefficients)
        high = [c % P for c in self.mod_full] + [1]
        while _deg(low):
            rr = _poly_rounded_div(high, low)
            nm, new = list(hm), list(high)
            for i in range(d + 1):
                for j in range(d + 1 - i):
                    nm[i + j] -= lm[i] * rr[j]
                    new[i + j] -= low[i] * rr[j]
            nm = [x % P for x in nm]
            new = [x % P for x in new]
            lm, low, hm, high = nm, new, lm, low
        inv_l0 = pow(low[0], P - 2, P)
        return type(self)([(c * inv_l0) % P for c in lm[:d]])

    def __truediv__(self, o):
        if isinstance(o, (int, FQ)):
            v = _val(o) if not isinstance(o, FQ) else o.n
            return self * pow(v, P - 2, P)
        return self * o.inv()

    def __eq__(self, o):
        return type(self) is type(o) and self.coeffs == o.coeffs

    def __hash__(self): return hash((type(self).__name__, tuple(self.coeffs)))

    def __repr__(self):
        return f"{type(self).__name__}({self.coeffs})"

    @classmethod
    def one(cls):
        return cls([1] + [0] * (cls.degree - 1))

    @classmethod
    def zero(cls):
        return cls([0] * cls.degree)


def _deg(p):
    d = len(p) - 1
    while d and p[d] == 0:
        d -= 1
    return d


def _poly_rounded_div(a, b):
    dega, degb = _deg(a), _deg(b)
    temp = list(a)
    out = [0] * len(a)
    inv_b = pow(b[degb], P - 2, P)
    for i in range(dega - degb, -1, -1):
        out[i] = (out[i] + temp[degb + i] * inv_b) % P
        for c in range(degb + 1):
            temp[c + i] = (temp[c + i] - out[i] * b[c]) % P
    return [x % P for x in out[:_deg(out) + 1] + [0] * (len(a) - _deg(out) - 1)]


class FQ2(FQP):
    degree = 2
    mod_full = [1, 0]                 # x^2 + 1
    mod_sparse = [(0, -1)]            # x^2 = -1


class FQ12(FQP):
    degree = 12
    mod_full = [82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0]   # x^12 - 18x^6 + 82
    mod_sparse = [(0, -82), (6, 18)]                      # x^12 = 18x^6 - 82


# -- group law (generic over field) -------------------------------------------

B = FQ(3)
B2 = FQ2([3, 0]) / FQ2([9, 1])
B12 = FQ12([3] + [0] * 11)

G1 = (FQ(1), FQ(2))
G2 = (
    FQ2([10857046999023057135944570762232829481370756359578518086990519993285655852781,
         11559732032986387107991004021392285783925812861821192530917403151452391805634]),
    FQ2([8495653923123431417604973247489272438418190587263600148770280649306958101930,
         4082367875863433681332203403145435568316851327593401208105741076214120093531]),
)


def is_on_curve(pt, b):
    if pt is None:
        return True
    x, y = pt
    return y * y - x * x * x == b


def double(pt):
    if pt is None:
        return None
    x, y = pt
    m = (x * x * 3) / (y * 2)
    newx = m * m - x * 2
    newy = m * (x - newx) - y
    return (newx, newy)


def add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if y1 == y2:
            return double(p1)
        return None
    m = (y2 - y1) / (x2 - x1)
    newx = m * m - x1 - x2
    newy = m * (x1 - newx) - y1
    return (newx, newy)


def neg(pt):
    if pt is None:
        return None
    x, y = pt
    return (x, -y)


def eq(p1, p2):
    return p1 == p2


# -- Jacobian coordinates (inversion-free hot path) ---------------------------
#
# (X, Y, Z) with x = X/Z^2, y = Y/Z^3; None stays the identity.  Works over
# any of the tower fields.  Scalar muls, MSMs and the fixed-base tables all
# run here; one inversion converts back at the end.


def to_jac(pt):
    if pt is None:
        return None
    x, y = pt
    return (x, y, type(x).one() if hasattr(x, "one") else FQ(1))


def from_jac(jpt):
    if jpt is None:
        return None
    x, y, z = jpt
    zinv = z.inv() if hasattr(z, "inv") else FQ(1) / z
    z2 = zinv * zinv
    return (x * z2, y * z2 * zinv)


def jdouble(p):
    if p is None:
        return None
    x, y, z = p
    a = x * x
    b = y * y
    cc = b * b
    t = x + b
    d = (t * t - a - cc) * 2
    e = a * 3
    f = e * e
    x3 = f - d * 2
    y3 = e * (d - x3) - cc * 8
    z3 = y * z * 2
    return (x3, y3, z3)


def jadd(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = z1 * z1
    z2z2 = z2 * z2
    u1 = x1 * z2z2
    u2 = x2 * z1z1
    s1 = y1 * z2 * z2z2
    s2 = y2 * z1 * z1z1
    if u1 == u2:
        if s1 == s2:
            return jdouble(p)
        return None
    h = u2 - u1
    hh = h + h
    i = hh * hh
    j = h * i
    r = (s2 - s1) * 2
    v = u1 * i
    x3 = r * r - j - v * 2
    y3 = r * (v - x3) - s1 * j * 2
    zs = z1 + z2
    z3 = (zs * zs - z1z1 - z2z2) * h
    return (x3, y3, z3)


def jmul(jpt, n: int):
    n %= R
    result = None
    addend = jpt
    while n:
        if n & 1:
            result = jadd(result, addend)
        addend = jdouble(addend)
        n >>= 1
    return result


def multiply(pt, n: int):
    return from_jac(jmul(to_jac(pt), n))


# -- fixed-base precomputed scalar multiplication -----------------------------


class FixedBase:
    """Precomputed doubling table for repeated scalar muls of one base."""

    def __init__(self, pt):
        self.table = []
        cur = to_jac(pt)
        for _ in range(256):
            self.table.append(cur)
            cur = jdouble(cur)

    def mul(self, n: int):
        n %= R
        result = None
        i = 0
        while n:
            if n & 1:
                result = jadd(result, self.table[i])
            n >>= 1
            i += 1
        return from_jac(result)


def msm(points, scalars):
    """Pippenger multi-scalar multiplication (window 8, Jacobian)."""
    w = 8
    n_windows = (256 + w - 1) // w
    jpts = [to_jac(p) for p in points]
    result = None
    for win in range(n_windows - 1, -1, -1):
        if result is not None:
            for _ in range(w):
                result = jdouble(result)
        buckets = {}
        shift = win * w
        for pt, s in zip(jpts, scalars):
            idx = (s >> shift) & ((1 << w) - 1)
            if idx and pt is not None:
                if idx in buckets:
                    buckets[idx] = jadd(buckets[idx], pt)
                else:
                    buckets[idx] = pt
        running = None
        acc = None
        for idx in range(max(buckets) if buckets else 0, 0, -1):
            if idx in buckets:
                running = jadd(running, buckets[idx])
            acc = jadd(acc, running)
        result = jadd(result, acc)
    return from_jac(result)


# -- pairing -------------------------------------------------------------------

_W = FQ12([0, 1] + [0] * 10)


def twist(pt):
    """G2 (over Fp2) -> curve over Fp12 via the sextic twist."""
    if pt is None:
        return None
    x, y = pt
    xc = [x.coeffs[0] - 9 * x.coeffs[1], x.coeffs[1]]
    yc = [y.coeffs[0] - 9 * y.coeffs[1], y.coeffs[1]]
    nx = FQ12([xc[0]] + [0] * 5 + [xc[1]] + [0] * 5)
    ny = FQ12([yc[0]] + [0] * 5 + [yc[1]] + [0] * 5)
    return (nx * _W * _W, ny * _W * _W * _W)


def cast_g1_fq12(pt):
    if pt is None:
        return None
    x, y = pt
    return (FQ12([x.n] + [0] * 11), FQ12([y.n] + [0] * 11))


def _linefunc(p1, p2, t):
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 != x2:
        m = (y2 - y1) / (x2 - x1)
        return m * (xt - x1) - (yt - y1)
    if y1 == y2:
        m = (x1 * x1 * 3) / (y1 * 2)
        return m * (xt - x1) - (yt - y1)
    return xt - x1


def miller_loop(q, p):
    """f_{ate}(Q, P) WITHOUT the final exponentiation (so products of
    loops can share one exponentiation, as gnark's PairingCheck does)."""
    if q is None or p is None:
        return FQ12.one()
    r_pt = q
    f = FQ12.one()
    for i in range(LOG_ATE_LOOP_COUNT, -1, -1):
        f = f * f * _linefunc(r_pt, r_pt, p)
        r_pt = double(r_pt)
        if ATE_LOOP_COUNT & (2 ** i):
            f = f * _linefunc(r_pt, q, p)
            r_pt = add(r_pt, q)
    q1 = (q[0] ** P, q[1] ** P)
    nq2 = (q1[0] ** P, -(q1[1] ** P))
    f = f * _linefunc(r_pt, q1, p)
    r_pt = add(r_pt, q1)
    f = f * _linefunc(r_pt, nq2, p)
    return f


def final_exponentiate(f):
    return f ** ((P ** 12 - 1) // R)


def pairing(q, p):
    """e(P, Q) with P in G1, Q in G2 (affine tuples; None = identity)."""
    assert is_on_curve(q, B2), "Q not on twisted curve"
    assert is_on_curve(p, B), "P not on curve"
    return final_exponentiate(miller_loop(twist(q), cast_g1_fq12(p)))


def pairing_check(pairs) -> bool:
    """prod e(P_i, Q_i) == 1, with one shared final exponentiation."""
    f = FQ12.one()
    for p, q in pairs:
        assert is_on_curve(p, B), "P not on curve"
        assert is_on_curve(q, B2), "Q not on twisted curve"
        f = f * miller_loop(twist(q), cast_g1_fq12(p))
    return final_exponentiate(f) == FQ12.one()
