# Frozen copy of zkm_tpu_torch/fri/verifier.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Verbatim below this header.
"""FRI verifier (host-side, exact python-int arithmetic).

Copy of zkm_tpu/fri/verifier.py (plonky2's `verify_fri_proof` /
`fri_verifier_query_round`).  Verification is cheap (37 queries x a few
cosets), so it runs on host ints.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np

from ..field import goldilocks as gl
from ..field import extension as gl2
from ..hash import poseidon as ps
from ..iop.challenger import Challenger
from .config import FriConfig
from .proof import FriProof

Ext = Tuple[int, int]

_INV2 = (gl.P + 1) // 2


def _host_digest_row(values: Sequence[int]) -> List[int]:
    return ps.hash_or_noop_host(list(values))


def _host_two_to_one(a: List[int], b: List[int]) -> List[int]:
    return ps.two_to_one_host(a, b)


def verify_merkle_proof_host(leaf_values: Sequence[int], index: int,
                             siblings: Sequence[np.ndarray],
                             cap: np.ndarray) -> None:
    digest = _host_digest_row(leaf_values)
    i = index
    for sib in siblings:
        s = [int(x) for x in sib]
        digest = _host_two_to_one(digest, s) if i % 2 == 0 \
            else _host_two_to_one(s, digest)
        i >>= 1
    if list(cap[i]) != digest:
        raise ValueError(f"merkle proof failed at cap index {i}")


def _fold_coset(evals: List[Ext], beta: Ext, x_index: int, arity_bits: int,
                shift: int, log_m: int) -> Ext:
    """Locally fold a coset of 2^arity_bits values (bit-reversed order within
    the chunk) down to the single next-layer value, via radix-2 cascades."""
    chunk = x_index >> arity_bits
    vals = list(evals)
    b = beta
    cur_shift = shift
    cur_log = log_m
    local_base = chunk << arity_bits
    width = 1 << arity_bits
    for _ in range(arity_bits):
        w = gl.primitive_root_of_unity(cur_log)
        new_vals = []
        for j in range(len(vals) // 2):
            gidx = local_base + 2 * j
            rev = int(bin(gidx)[2:].zfill(cur_log)[::-1], 2)
            x = (cur_shift * pow(w, rev, gl.P)) % gl.P
            v0, v1 = vals[2 * j], vals[2 * j + 1]
            s = ((v0[0] + v1[0]) % gl.P, (v0[1] + v1[1]) % gl.P)
            d = ((v0[0] - v1[0]) % gl.P, (v0[1] - v1[1]) % gl.P)
            inv_x = gl.host_inv(x)
            t = gl2.host_mul(b, (d[0] * inv_x % gl.P, d[1] * inv_x % gl.P))
            folded = (((s[0] + t[0]) * _INV2) % gl.P,
                      ((s[1] + t[1]) * _INV2) % gl.P)
            new_vals.append(folded)
        vals = new_vals
        local_base >>= 1
        width >>= 1
        b = gl2.host_mul(b, b)
        cur_shift = (cur_shift * cur_shift) % gl.P
        cur_log -= 1
    assert len(vals) == 1
    return vals[0]


def verify_fri_proof(proof: FriProof,
                     combine_initial: Callable[[int, List[np.ndarray]], Ext],
                     oracle_caps: Sequence[np.ndarray],
                     degree_bits: int,
                     challenger: Challenger,
                     config: FriConfig) -> None:
    """Replays the transcript and checks every query round.

    `combine_initial(x_index, evals_per_oracle) -> Ext` computes the
    expected initial combined-polynomial value at the query point (the
    caller binds alpha, opening points, and opened values).
    Raises ValueError on any failure.
    """
    arities = config.reduction_arity_bits(degree_bits)
    betas: List[Ext] = []
    for cap in proof.commit_phase_merkle_caps:
        challenger.observe_cap(cap)
        betas.append(challenger.get_extension_challenge())

    for c0, c1 in proof.final_poly:
        challenger.observe_extension((int(c0), int(c1)))

    challenger.observe_element(proof.pow_witness)
    pow_response = challenger.get_challenge()
    if pow_response >> (64 - config.proof_of_work_bits) != 0:
        raise ValueError("proof-of-work check failed")

    lde_size = 1 << (degree_bits + config.rate_bits)
    indices = [challenger.get_challenge() % lde_size
               for _ in range(config.num_query_rounds)]

    for x_index, round_proof in zip(indices, proof.query_round_proofs):
        # initial oracle openings
        for o, (evals, sibs) in enumerate(zip(
                round_proof.initial_trees_proof.evals_per_oracle,
                round_proof.initial_trees_proof.merkle_proofs)):
            verify_merkle_proof_host(
                [int(v) for v in evals], x_index, sibs, oracle_caps[o])

        old_eval = combine_initial(
            x_index, round_proof.initial_trees_proof.evals_per_oracle)

        idx = x_index
        shift = gl.GENERATOR
        log_m = degree_bits + config.rate_bits
        for step, arity_bits, beta, cap in zip(
                round_proof.steps, arities, betas,
                proof.commit_phase_merkle_caps):
            arity = 1 << arity_bits
            evals = [(int(e[0]), int(e[1])) for e in step.evals]
            within = idx & (arity - 1)
            if evals[within] != old_eval:
                raise ValueError("fold consistency check failed")
            coset_idx = idx >> arity_bits
            leaf = [e[0] for e in step.evals] + [e[1] for e in step.evals]
            verify_merkle_proof_host(leaf, coset_idx, step.merkle_proof, cap)
            old_eval = _fold_coset(evals, beta, idx, arity_bits, shift, log_m)
            for _ in range(arity_bits):
                shift = (shift * shift) % gl.P
            log_m -= arity_bits
            idx = coset_idx

        # final polynomial evaluation at the folded domain point
        w = gl.primitive_root_of_unity(log_m)
        rev = int(bin(idx)[2:].zfill(log_m)[::-1], 2) if log_m else 0
        x_final = (shift * pow(w, rev, gl.P)) % gl.P
        acc: Ext = (0, 0)
        for c0, c1 in reversed(proof.final_poly):
            acc = gl2.host_mul(acc, (x_final, 0))
            acc = ((acc[0] + int(c0)) % gl.P, (acc[1] + int(c1)) % gl.P)
        if acc != old_eval:
            raise ValueError("final polynomial evaluation mismatch")
