"""Groth16 over BN254, pure Python.

Copy of zkm_tpu/snark/groth16.py: with `seed` and `blind_seed` pinned, the
keys and proofs are bit-identical to the reference's.

The in-repo analog of the reference's Go gnark Groth16 calls
(recursion/src/snark/libsnark/snark_prover.go:262-309: SetupAndGenerate-
SolVerifier / Prove).  Implements the standard Groth16 scheme (Groth,
EUROCRYPT'16): QAP via a radix-2 evaluation domain over Fr (BN254's
scalar field is 2-adic to 2^28), trusted setup from explicit toxic
randomness, prove with (r, s) blinding, verify via the 4-pairing product
with one shared final exponentiation.

Performance is irrelevant here (one wrap per block, matching the
reference's out-of-process Go prover), so this favors clarity: Lagrange
evaluations at tau in the setup, NTT-based H(X) computation in the prover.
"""

from __future__ import annotations

import hashlib
import secrets
from dataclasses import dataclass
from typing import List, Optional, Tuple

from . import bn254 as c
from .bn254 import R as FR
from .r1cs import R1CS

# -- Fr utilities ---------------------------------------------------------------


def _find_two_adic_root(k: int) -> int:
    """Element of exact order 2^k in Fr* (verified, not trusted)."""
    two_adicity = 28
    assert k <= two_adicity
    for g in range(5, 100):
        w = pow(g, (FR - 1) >> two_adicity, FR)
        if pow(w, 1 << (two_adicity - 1), FR) != 1:
            # w has exact order 2^28; square down to 2^k
            for _ in range(two_adicity - k):
                w = (w * w) % FR
            return w
    raise RuntimeError("no 2-adic generator found")


def _ntt(vals: List[int], root: int, inverse: bool = False) -> List[int]:
    n = len(vals)
    assert n & (n - 1) == 0
    if inverse:
        root = pow(root, FR - 2, FR)
    a = list(vals)
    # bit-reverse
    j = 0
    for i in range(1, n):
        bit = n >> 1
        while j & bit:
            j ^= bit
            bit >>= 1
        j |= bit
        if i < j:
            a[i], a[j] = a[j], a[i]
    length = 2
    while length <= n:
        wlen = pow(root, n // length, FR)
        for i in range(0, n, length):
            w = 1
            half = length >> 1
            for k in range(i, i + half):
                u, v = a[k], a[k + half] * w % FR
                a[k] = (u + v) % FR
                a[k + half] = (u - v) % FR
                w = w * wlen % FR
        length <<= 1
    if inverse:
        n_inv = pow(n, FR - 2, FR)
        a = [x * n_inv % FR for x in a]
    return a


# -- key containers --------------------------------------------------------------


@dataclass
class VerifyingKey:
    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    ic: List[tuple]          # [gamma^-1 (beta A_i + alpha B_i + C_i)]_1,
    #                          i = 0..num_public


@dataclass
class ProvingKey:
    vk: VerifyingKey
    alpha_g1: tuple
    beta_g1: tuple
    beta_g2: tuple
    delta_g1: tuple
    delta_g2: tuple
    a_g1: List[tuple]        # [A_i(tau)]_1
    b_g1: List[tuple]        # [B_i(tau)]_1
    b_g2: List[tuple]        # [B_i(tau)]_2
    k_g1: List[Optional[tuple]]  # [delta^-1 (beta A_i + alpha B_i + C_i)]_1
    #                              for private i (None for public slots)
    h_g1: List[tuple]        # [delta^-1 tau^i Z(tau)]_1, i < n-1
    domain_bits: int


@dataclass
class Proof:
    a: tuple
    b: tuple                 # G2
    c: tuple


# -- QAP ---------------------------------------------------------------------------


def _qap_at_tau(cs: R1CS, tau: int):
    """A_i(tau), B_i(tau), C_i(tau) for every wire, plus Z(tau), via
    Lagrange evaluation over the radix-2 domain."""
    n = 1
    while n < len(cs.constraints):
        n <<= 1
    k = n.bit_length() - 1
    omega = _find_two_adic_root(k) if n > 1 else 1

    z_tau = (pow(tau, n, FR) - 1) % FR
    n_inv = pow(n, FR - 2, FR)
    # L_j(tau) = omega^j * Z(tau) / (n * (tau - omega^j))
    lag = []
    wj = 1
    denoms = []
    for j in range(n):
        denoms.append((tau - wj) % FR)
        wj = wj * omega % FR
    inv_denoms = _batch_inv(denoms)
    wj = 1
    for j in range(n):
        lag.append(wj * z_tau % FR * n_inv % FR * inv_denoms[j] % FR)
        wj = wj * omega % FR

    nw = cs.num_wires
    a = [0] * nw
    b = [0] * nw
    cc = [0] * nw
    for j, (la, lb, lc) in enumerate(cs.constraints):
        lj = lag[j]
        for w, coeff in la.items():
            a[w] = (a[w] + coeff * lj) % FR
        for w, coeff in lb.items():
            b[w] = (b[w] + coeff * lj) % FR
        for w, coeff in lc.items():
            cc[w] = (cc[w] + coeff * lj) % FR
    return a, b, cc, z_tau, k, omega


def _batch_inv(xs: List[int]) -> List[int]:
    prefix = [1]
    for x in xs:
        prefix.append(prefix[-1] * x % FR)
    inv_all = pow(prefix[-1], FR - 2, FR)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        out[i] = prefix[i] * inv_all % FR
        inv_all = inv_all * xs[i] % FR
    return out


# -- setup ------------------------------------------------------------------------


def setup(cs: R1CS, seed: Optional[bytes] = None) -> ProvingKey:
    """Trusted setup (single-party analog of the reference's gnark setup,
    snark_prover.go:268).

    Toxic randomness comes from OS entropy by default and the trapdoor
    values (alpha/beta/gamma/delta/tau) are locals dropped when this
    function returns — only group-element powers survive in the key.  A
    single-party setup still requires trusting the machine that ran it; a
    production deployment replaces this with an MPC ceremony and
    distributes the resulting VerifyingKey (see docs/snark_wrap.md).
    Passing `seed` pins the randomness for reproducible tests ONLY —
    anyone who knows the seed can recompute the trapdoor and forge
    proofs."""
    if seed is None:
        seed = secrets.token_bytes(32)

    def rand_fr(tag: bytes) -> int:
        return int.from_bytes(hashlib.sha512(seed + tag).digest(), "big") % FR

    alpha, beta, gamma, delta, tau = (rand_fr(t) for t in
                                      (b"alpha", b"beta", b"gamma",
                                       b"delta", b"tau"))
    a, b, cc, z_tau, domain_bits, _ = _qap_at_tau(cs, tau)
    n = 1 << domain_bits
    nw = cs.num_wires
    npub = cs.num_public

    g1 = c.FixedBase(c.G1)
    g2 = c.FixedBase(c.G2)
    gamma_inv = pow(gamma, FR - 2, FR)
    delta_inv = pow(delta, FR - 2, FR)

    ic = []
    k_g1: List[Optional[tuple]] = []
    for i in range(nw):
        k_i = (beta * a[i] + alpha * b[i] + cc[i]) % FR
        if i <= npub:
            ic.append(g1.mul(k_i * gamma_inv % FR))
            k_g1.append(None)
        else:
            k_g1.append(g1.mul(k_i * delta_inv % FR))

    h_g1 = []
    tpow = 1
    for _ in range(n - 1):
        h_g1.append(g1.mul(tpow * z_tau % FR * delta_inv % FR))
        tpow = tpow * tau % FR

    vk = VerifyingKey(alpha_g1=g1.mul(alpha), beta_g2=g2.mul(beta),
                      gamma_g2=g2.mul(gamma), delta_g2=g2.mul(delta),
                      ic=ic)
    return ProvingKey(
        vk=vk, alpha_g1=vk.alpha_g1, beta_g1=g1.mul(beta),
        beta_g2=vk.beta_g2, delta_g1=g1.mul(delta), delta_g2=vk.delta_g2,
        a_g1=[g1.mul(x) for x in a], b_g1=[g1.mul(x) for x in b],
        b_g2=[g2.mul(x) for x in b], k_g1=k_g1, h_g1=h_g1,
        domain_bits=domain_bits)


# -- prove ------------------------------------------------------------------------


def _h_coeffs(cs: R1CS, domain_bits: int) -> List[int]:
    """Coefficients of H(X) = (A(X)B(X) - C(X)) / Z(X) via coset NTTs."""
    n = 1 << domain_bits
    omega = _find_two_adic_root(domain_bits) if n > 1 else 1
    ev_a = [0] * n
    ev_b = [0] * n
    ev_c = [0] * n
    for j, (la, lb, lc) in enumerate(cs.constraints):
        ev_a[j] = cs._eval(la)
        ev_b[j] = cs._eval(lb)
        ev_c[j] = cs._eval(lc)
    ca = _ntt(ev_a, omega, inverse=True)
    cb = _ntt(ev_b, omega, inverse=True)
    ccf = _ntt(ev_c, omega, inverse=True)
    # evaluate on the coset g*<omega>: scale coeffs by g^i then NTT
    g = 5
    gp = 1
    for i in range(n):
        ca[i] = ca[i] * gp % FR
        cb[i] = cb[i] * gp % FR
        ccf[i] = ccf[i] * gp % FR
        gp = gp * g % FR
    ea = _ntt(ca, omega)
    eb = _ntt(cb, omega)
    ec = _ntt(ccf, omega)
    # Z on the coset is the constant g^n - 1
    z_inv = pow(pow(g, n, FR) - 1, FR - 2, FR)
    eh = [(x * y - z) % FR * z_inv % FR for x, y, z in zip(ea, eb, ec)]
    ch = _ntt(eh, omega, inverse=True)
    # unscale from the coset
    g_inv = pow(g, FR - 2, FR)
    gp = 1
    for i in range(n):
        ch[i] = ch[i] * gp % FR
        gp = gp * g_inv % FR
    # deg H <= n-2, so the top coefficient must vanish
    assert ch[-1] == 0, "H degree overflow (unsatisfied R1CS?)"
    return ch[:n - 1]


def prove(pk: ProvingKey, cs: R1CS,
          blind_seed: Optional[bytes] = None) -> Proof:
    """Groth16 prove.  The blinding scalars r, s come from OS entropy by
    default; a derivable r/s would let anyone strip the blinding from A/B
    and break zero-knowledge.  `blind_seed` pins them for tests only."""
    assert cs.is_satisfied(), "witness does not satisfy the R1CS"
    w = cs.values
    npub = cs.num_public
    if blind_seed is None:
        blind_seed = secrets.token_bytes(32)

    def rand_fr(tag: bytes) -> int:
        h = hashlib.sha512(blind_seed + bytes(str(w[1:npub + 1]), "ascii")
                           + tag).digest()
        return int.from_bytes(h, "big") % FR

    r = rand_fr(b"r")
    s = rand_fr(b"s")

    a_acc = c.msm(pk.a_g1, w)
    a = c.add(c.add(pk.alpha_g1, a_acc), c.multiply(pk.delta_g1, r))

    b1 = c.add(c.add(pk.beta_g1, c.msm(pk.b_g1, w)),
               c.multiply(pk.delta_g1, s))
    b2 = c.add(c.add(pk.beta_g2, c.msm(pk.b_g2, w)),
               c.multiply(pk.delta_g2, s))

    h = _h_coeffs(cs, pk.domain_bits)
    h_acc = c.msm(pk.h_g1[:len(h)], h)
    k_pts = [pt for pt in pk.k_g1[npub + 1:]]
    k_acc = c.msm(k_pts, w[npub + 1:])

    cpt = c.add(k_acc, h_acc)
    cpt = c.add(cpt, c.multiply(a, s))
    cpt = c.add(cpt, c.multiply(b1, r))
    cpt = c.add(cpt, c.neg(c.multiply(pk.delta_g1, r * s % FR)))
    return Proof(a=a, b=b2, c=cpt)


# -- verify -----------------------------------------------------------------------


def verify(vk: VerifyingKey, public_inputs: List[int], proof: Proof) -> bool:
    """e(A,B) == e(alpha,beta) * e(sum IC, gamma) * e(C, delta)."""
    if len(public_inputs) != len(vk.ic) - 1:
        return False
    acc = vk.ic[0]
    for pt, x in zip(vk.ic[1:], public_inputs):
        acc = c.add(acc, c.multiply(pt, x % FR))
    return c.pairing_check([
        (c.neg(proof.a), proof.b),
        (vk.alpha_g1, vk.beta_g2),
        (acc, vk.gamma_g2),
        (proof.c, vk.delta_g2),
    ])
