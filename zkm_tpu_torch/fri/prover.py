"""FRI prover: value-space folding on the device, transcript on the host.

Counterpart of `zkm_tpu/fri/prover.py` (plonky2's `fri_proof`: fold arity
16, 37 queries, PoW 16 bits):
  * an arity-2^k fold with beta is k radix-2 folds in value space on the
    bit-reversed LDE, with beta^(2^t);
  * each layer's leaves are arity-sized cosets laid out [c0 x arity |
    c1 x arity], hashed into a Merkle tree;
  * the proof-of-work grind tries 2^16 candidates per batch, one Poseidon
    permutation each, and takes the smallest that succeeds.

Over a tp group (`comm`) each rank holds a contiguous block of the
bit-reversed values.  An arity-sized coset is contiguous there, so the
leaves, the layer's subtree (commit/merkle.py) and the fold stay local;
a layer with fewer than tp * arity values is gathered and the rest runs
on every rank alike, as do the final polynomial and the grind (each
rank's challenger replica finds the one-card witness itself).  Query
rows and paths come from the ranks that hold them.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..commit.merkle import build_merkle_tree
from ..commit.polynomial_batch import PolynomialBatch
from ..convert import to_u64
from ..field import extension as gl2
from ..field import goldilocks as gl
from ..field import ntt
from ..hash import poseidon as ps
from ..iop.challenger import Challenger
from ..utils.timing import step
from .config import FriConfig
from .proof import (FriInitialTreeProof, FriProof, FriQueryRound, FriQueryStep)

_INV2 = (gl.P + 1) // 2
POW_BATCH = 1 << 16


@lru_cache(maxsize=64)
def _even_point_invs(log_m: int, shift: int,
                     device: torch.device) -> torch.Tensor:
    """1/x_j for the even element of pair j on a bit-reversed domain:
    shift * H, |H| = 2^log_m; pair j's even element is global index 2j,
    the point shift * w^{rev_{log_m-1}(j)} with w of order 2^log_m."""
    w_inv = gl.host_inv(gl.primitive_root_of_unity(log_m))
    pows = gl.powers(w_inv, 1 << (log_m - 1), device)
    rev = ntt.bit_reverse_tensor(log_m - 1, device)
    return gl.mul(pows.index_select(0, rev), gl.host_inv(shift))


def _fold_step(values: gl2.Gf2, beta: Tuple[int, int],
               inv_xs: torch.Tensor) -> gl2.Gf2:
    """folded_j = (v_2j + v_2j+1)/2 + beta (v_2j - v_2j+1) / (2 x_j)."""
    v0 = (values[0][0::2], values[1][0::2])
    v1 = (values[0][1::2], values[1][1::2])
    s = gl2.add(v0, v1)
    d = gl2.sub(v0, v1)
    term = gl2.mul(gl2.mul_base(d, inv_xs), beta)
    return gl2.mul_base(gl2.add(s, term), _INV2)


def fold_layer(values: gl2.Gf2, beta: Tuple[int, int], arity_bits: int,
               log_m: int, shift: int, comm=None) -> Tuple[gl2.Gf2, int, int]:
    """Arity-2^k fold = k radix-2 folds with beta^(2^t).  Returns (folded
    values, new log size, new shift).  Over a tp group `comm` the values
    are this rank's block."""
    for _ in range(arity_bits):
        inv_xs = _even_point_invs(log_m, shift, values[0].device)
        if comm is not None:
            h = values[0].shape[0] // 2
            inv_xs = inv_xs[comm.rank * h:(comm.rank + 1) * h]
        values = _fold_step(values, beta, inv_xs)
        beta = gl2.host_mul(beta, beta)
        log_m -= 1
        shift = gl.host_mul(shift, shift)
    return values, log_m, shift


def _chunk_leaves(values: gl2.Gf2, arity: int) -> torch.Tensor:
    """(M,) ext values -> (M/arity, 2*arity) leaf rows [c0s | c1s]."""
    return torch.cat([values[0].reshape(-1, arity),
                      values[1].reshape(-1, arity)], dim=1)


def _chunk_and_tree(values: gl2.Gf2, arity: int, cap_height: int,
                    comm=None):
    leaves = _chunk_leaves(values, arity)
    return leaves, build_merkle_tree(leaves, cap_height, comm)


# ---------------------------------------------------------------------------
# Proof of work.
# ---------------------------------------------------------------------------

def _pow_batch(state: List[int], slot: int, start: int, batch: int,
               bits: int, device) -> int:
    """Try candidates start .. start + batch - 1 in `slot` of `state`;
    return the offset of the smallest whose squeezed challenge has `bits`
    leading zero bits, or -1."""
    states = gl.from_ints(state, device).repeat(batch, 1)
    states[:, slot] = torch.arange(start, start + batch, dtype=torch.int64,
                                   device=device)
    response = ps.permute(states)[:, ps.SPONGE_RATE - 1]
    ok = gl._shr(response, 64 - bits) == 0
    hits = torch.nonzero(ok)
    return int(hits[0, 0]) if hits.numel() else -1


def fri_proof_of_work(challenger: Challenger, config: FriConfig,
                      device) -> int:
    """The smallest witness w such that observing w and squeezing one
    challenge gives proof_of_work_bits leading zero bits.  Candidates go in
    order, 2^16 per batch (fewer for a small bit count: 16 times the
    expected number of tries), so the batch size never changes w."""
    bits = config.proof_of_work_bits
    batch = min(POW_BATCH, 1 << (bits + 4))
    base = challenger.clone()
    state = list(base.state)
    for i, x in enumerate(base.input_buffer):
        state[i] = x
    slot = len(base.input_buffer)
    assert slot < ps.SPONGE_RATE
    start = 0
    while True:
        res = _pow_batch(state, slot, start, batch, bits, device)
        if res >= 0:
            witness = start + res
            c = challenger.clone()
            c.observe_element(witness)
            assert c.get_challenge() >> (64 - bits) == 0
            return witness
        start += batch
        assert start < 1 << 34, "PoW grind failed"


# ---------------------------------------------------------------------------
# Main prover entry.
# ---------------------------------------------------------------------------

def fri_prove(oracles: Sequence[PolynomialBatch],
              initial_values: gl2.Gf2,
              degree_bits: int,
              challenger: Challenger,
              config: FriConfig, timer=None, comm=None) -> FriProof:
    """Commit-fold-grind-query.  `initial_values`: the alpha-combined
    opening quotient over the bit-reversed LDE domain of size
    2^(degree_bits + rate_bits) (over a tp group `comm`, this rank's
    block); the caller has observed the oracle caps and drawn alpha."""
    log_m = degree_bits + config.rate_bits
    shift = gl.GENERATOR
    arities = config.reduction_arity_bits(degree_bits)
    device = initial_values[0].device

    values = initial_values
    trees = []
    caps = []
    layer_comm = comm       # None once the layers are gathered

    def gathered(v):
        return (comm.gather_points(v[0]), comm.gather_points(v[1]))

    with step(timer, "fri"):
        for arity_bits in arities:
            if layer_comm is not None and \
                    values[0].shape[0] < 1 << arity_bits:
                values, layer_comm = gathered(values), None
            leaves, tree = _chunk_and_tree(values, 1 << arity_bits,
                                           config.cap_height, layer_comm)
            trees.append((tree, leaves))
            cap = to_u64(tree.cap)
            caps.append(cap)
            challenger.observe_cap(cap)
            beta = challenger.get_extension_challenge()
            values, log_m, shift = fold_layer(values, beta, arity_bits,
                                              log_m, shift, layer_comm)
        if layer_comm is not None:
            values = gathered(values)

        # Final polynomial: undo the bit reversal, inverse coset NTT, trim
        # to the true degree (higher coefficients are identically zero).
        rev = ntt.bit_reverse_tensor(log_m, device)
        c0 = to_u64(ntt.coset_intt(values[0].index_select(0, rev), shift))
        c1 = to_u64(ntt.coset_intt(values[1].index_select(0, rev), shift))
        fdeg = 1 << (degree_bits - sum(arities))
        assert not c0[fdeg:].any() and not c1[fdeg:].any(), \
            "final poly not low-degree"
        final_poly = np.stack([c0[:fdeg], c1[:fdeg]], axis=1)
        for i in range(fdeg):
            challenger.observe_extension((int(c0[i]), int(c1[i])))

    with step(timer, "pow"):
        pow_witness = fri_proof_of_work(challenger, config, device)
    challenger.observe_element(pow_witness)
    response = challenger.get_challenge()
    assert response >> (64 - config.proof_of_work_bits) == 0

    lde_size = 1 << (degree_bits + config.rate_bits)
    indices = [challenger.get_challenge() % lde_size
               for _ in range(config.num_query_rounds)]

    with step(timer, "fri"):
        query_rounds = extract_query_rounds(oracles, trees, arities, indices)
    return FriProof(commit_phase_merkle_caps=caps,
                    query_round_proofs=query_rounds,
                    final_poly=final_poly,
                    pow_witness=pow_witness)


def extract_query_rounds(oracles, trees, arities, indices):
    """Rows and Merkle paths of every oracle and fold layer at the query
    indices, gathered on the device and fetched to the host.

    trees: [(MerkleTree, leaves)] per commit-phase layer."""
    nq = len(indices)
    idx = np.asarray(indices, dtype=np.int64)
    oracle_rows, oracle_paths = [], []
    for o in oracles:
        rows, paths = o.open_rows(idx)
        oracle_rows.append(rows)
        oracle_paths.append(paths)

    step_data = []
    for (tree, leaves), arity_bits in zip(trees, arities):
        idx = idx >> arity_bits
        rows, paths = tree.open(idx, leaves)
        step_data.append((1 << arity_bits, rows, paths))

    query_rounds = []
    for q in range(nq):
        initial = FriInitialTreeProof(
            [rows[q] for rows in oracle_rows],
            [paths[q] for paths in oracle_paths])
        steps = []
        for arity, rows, paths in step_data:
            row = rows[q]
            evals = np.stack([row[:arity], row[arity:]], axis=1)
            steps.append(FriQueryStep(evals=evals, merkle_proof=paths[q]))
        query_rounds.append(FriQueryRound(initial, steps))
    return query_rounds
