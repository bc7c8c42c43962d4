"""Multi-table STARK prover.

Counterpart of `zkm_tpu/stark/prover.py` (zkMIPS prover/src/prover.rs).
The transcript discipline is mirrored exactly: one host challenger for the
whole AllProof; order = all trace caps -> public values -> CTL challenge
set -> per table (in table order): compact state -> aux cap -> alphas ->
quotient cap -> zeta -> openings -> FRI.

  * quotient constraints evaluate over the whole 2n-point coset at once,
    as a level schedule of tensor ops (stark/expr.py);
  * Z_H on the coset takes only two values (g^n (-1)^i - 1), so the
    division is two constant inversions;
  * trace/aux quotient-domain values come from rate-1 coset LDEs of the
    committed coefficients; the next-row view on the 2n coset is a roll
    by 2;
  * with debug=True every table's constraints are first checked on H
    itself (`check_constraints`), which draws nothing from the
    transcript: the proof is the same.

Over a tp mesh (`mesh=`, parallel/sharding.py) the proof is the same
too.  Every rank gets the whole traces and keeps its blocks: a column
shard of each table for its commitments (commit/polynomial_batch.py), a
block of rows plus the next row for the CTL and lookup columns (their
running sums carry across blocks, stark/cross_table_lookup.py); aux
columns move to column shards with one all_to_all; the quotient is
evaluated on a block of the 2n coset points with a two-point halo from
the next block, then moved to column shards of its chunks; openings are
gathered, and FRI runs on the blocks of the bit-reversed LDE
(fri/oracle.py, fri/prover.py).  Every rank observes the same caps and
openings on its own host challenger, so all ranks draw the same
challenges and assemble the same AllProof.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence

import torch

from ..commit.polynomial_batch import PolynomialBatch
from ..device import resolve_device
from ..field import extension as gl2
from ..field import goldilocks as gl
from ..field import ntt
from ..fri import oracle as fri_oracle
from ..iop.challenger import Challenger
from ..parallel.comm import halo_points, split_counts, tp_group
from ..utils.timing import step
from .config import StarkConfig
from .cross_table_lookup import (cross_table_lookup_data,
                                 get_grand_product_challenge_set)
from .lookup import lookup_helper_columns
from .proof import (AllProof, PublicValues, StarkOpeningSet, StarkProof,
                    StarkProofWithMetadata)
from .vanishing_poly import eval_vanishing_scheduled

P = gl.P


def observe_public_values(challenger: Challenger, pv: PublicValues):
    challenger.observe_elements(pv.roots_before.root)
    challenger.observe_elements(pv.roots_after.root)
    challenger.observe_elements(list(pv.userdata))


def public_inputs_of(stark, pv: PublicValues) -> tuple:
    """The per-table public-input scalars selected from the proof claim."""
    if not stark.num_public_inputs:
        return ()
    return tuple(stark.public_inputs(
        [int(v) for v in pv.roots_before.root],
        [int(v) for v in pv.roots_after.root],
        [int(b) for b in pv.userdata]))


def ctl_structure_of(ctl_data, chal_index) -> tuple:
    """Static description of a table's CTL aux layout; chal_index maps a
    challenge's (beta, gamma) to its index in the challenge list."""
    return tuple(
        (len(z.helper_columns), chal_index[(z.challenge.beta,
                                            z.challenge.gamma)],
         tuple(tuple(c) for c in z.columns), tuple(z.filters))
        for z in ctl_data.zs_columns)


@lru_cache(maxsize=16)
def quotient_domain_tables(degree_bits: int, device: torch.device):
    """(z_last, lagrange_first, lagrange_last, 1/Z_H) over the 2n quotient
    coset g * H_2n, in natural order."""
    n = 1 << degree_bits
    m = 2 * n
    xs = gl.mul(gl.powers(gl.primitive_root_of_unity(degree_bits + 1), m,
                          device), gl.GENERATOR)
    g_last = gl.host_pow(gl.primitive_root_of_unity(degree_bits), n - 1)
    z_last = gl.sub(xs, g_last)
    gn = gl.host_pow(gl.GENERATOR, n)
    even = torch.arange(m, device=device) % 2 == 0
    zh_even, zh_odd = (gn - 1) % P, (-gn - 1) % P

    def two_valued(a: int, b: int) -> torch.Tensor:
        return torch.where(even, gl.full((), a, device), gl.full((), b, device))

    z_h = two_valued(zh_even, zh_odd)
    inv_zh = two_valued(gl.host_inv(zh_even), gl.host_inv(zh_odd))
    n_inv = gl.host_inv(n)
    lag_first = gl.mul(gl.mul(z_h, n_inv), gl.inverse(gl.sub(xs, 1)))
    lag_last = gl.mul(gl.mul(z_h, (n_inv * g_last) % P),
                      gl.inverse(gl.sub(xs, g_last)))
    return z_last, lag_first, lag_last, inv_zh


def quotient_values(stark, degree_bits: int, trace_coeffs: torch.Tensor,
                    aux_coeffs: torch.Tensor, alphas, num_lookup: int,
                    ctl_structure, challenges, publics=(),
                    comm=None, col_counts=None) -> List[torch.Tensor]:
    """The alpha-combined vanishing polynomial / Z_H over the quotient
    coset (size 2n): one (2n,) tensor per alpha.  Over a tp group `comm`
    the coefficients are column shards (col_counts: the trace's and the
    aux columns' counts per rank) and the result is this rank's block of
    the 2n points."""
    tables = quotient_domain_tables(degree_bits, trace_coeffs.device)
    if comm is None:
        full = torch.cat([ntt.lde(trace_coeffs, 1), ntt.lde(aux_coeffs, 1)])
        full_next = torch.roll(full, -2, dims=-1)
    else:
        m = 2 << degree_bits
        b = m // comm.size
        block = comm.cols_to_rows(
            [(ntt.lde(trace_coeffs, 1), col_counts[0]),
             (ntt.lde(aux_coeffs, 1), col_counts[1])],
            halo_points(m, comm.size, 2, trace_coeffs.device))
        full, full_next = block[:, :b], block[:, 2:]
        tables = [t[comm.rank * b:(comm.rank + 1) * b] for t in tables]
    z_last, lag_first, lag_last, inv_zh = tables
    accs = eval_vanishing_scheduled(
        stark, num_lookup, ctl_structure, full, full_next, challenges,
        alphas, (z_last, lag_first, lag_last), publics)
    return [gl.mul(acc, inv_zh) for acc in accs]


def check_constraints(stark, trace_values: torch.Tensor,
                      aux_values: torch.Tensor, alphas, num_lookup: int,
                      ctl_structure, challenges, publics=()) -> None:
    """Evaluate the whole vanishing polynomial on H itself (zkMIPS
    `check_constraints`, prover.rs:793-910): row selectors become
    indicator vectors, and every accumulator must vanish on every row.
    Asserts with the rows that fail."""
    n = trace_values.shape[-1]
    device = trace_values.device
    full = torch.cat([trace_values, aux_values])
    g = gl.primitive_root_of_unity(n.bit_length() - 1)
    z_last = gl.sub(gl.powers(g, n, device), gl.host_pow(g, n - 1))
    first = torch.zeros(n, dtype=torch.int64, device=device)
    last = first.clone()
    first[0] = last[-1] = 1
    accs = eval_vanishing_scheduled(
        stark, num_lookup, ctl_structure, full, torch.roll(full, -1, dims=-1),
        challenges, alphas, (z_last, first, last), publics)
    for i, acc in enumerate(accs):
        bad = torch.nonzero(acc).flatten()
        assert bad.numel() == 0, (
            f"{type(stark).__name__}: constraints failed for alpha {i} at "
            f"rows {bad[:10].tolist()}")


def quotient_chunks(quotient_values: List[torch.Tensor], n: int,
                    comm=None) -> torch.Tensor:
    """Coset values (2n) -> coefficients -> two degree-n chunks each,
    challenge-major: (2 * len(quotient_values), n).  Over a tp group the
    values are this rank's block of points, and the result is its column
    shard: the chunks of its `split_counts(A, tp)` alphas."""
    values = torch.stack(quotient_values)
    if comm is not None:
        values = comm.rows_to_cols(values,
                                   split_counts(len(quotient_values),
                                                comm.size))
    coeffs = ntt.coset_intt(values)                         # (A, 2n)
    return coeffs.reshape(-1, n)


def prove_single_table(stark, config: StarkConfig, trace_values: torch.Tensor,
                       trace_commitment: PolynomialBatch, ctl_data,
                       ctl_challenges, challenger: Challenger,
                       publics=(), timer=None,
                       debug: bool = False,
                       mesh=None) -> StarkProofWithMetadata:
    """Over a tp mesh, trace_values is this rank's block of rows plus
    its halo row."""
    comm = trace_commitment.comm
    n = trace_commitment.degree
    degree_bits = n.bit_length() - 1
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    device = trace_values.device

    init_challenger_state = challenger.compact()

    with step(timer, "ctl"):
        aux_polys: List[torch.Tensor] = []
        if stark.uses_lookups():
            for lookup in stark.lookups():
                for ch in ctl_challenges.challenges:
                    aux_polys.extend(lookup_helper_columns(
                        lookup, trace_values, ch.beta,
                        stark.constraint_degree, comm))
        num_lookup_columns = len(aux_polys)
        aux_polys.extend(ctl_data.ctl_helper_polys())
        aux_polys.extend(ctl_data.ctl_z_polys())
        assert aux_polys, "No CTL?"
        aux_values = torch.stack(aux_polys)
    with step(timer, "aux_commit"):
        aux_counts = None
        if comm is not None:
            aux_counts = split_counts(len(aux_polys), comm.size)
            aux_values = comm.rows_to_cols(aux_values, aux_counts)
        aux_commitment = PolynomialBatch.from_values(
            aux_values, rate_bits, cap_height, device=device, mesh=mesh,
            col_counts=aux_counts)
        challenger.observe_cap(aux_commitment.cap_u64())

    alphas = challenger.get_n_challenges(config.num_challenges)

    chal_index = {(c.beta, c.gamma): i
                  for i, c in enumerate(ctl_challenges.challenges)}
    ctl_structure = ctl_structure_of(ctl_data, chal_index)
    challenges = [(c.beta, c.gamma) for c in ctl_challenges.challenges]

    if debug:
        with step(timer, "check_constraints"):
            check_constraints(stark, trace_values, aux_values, alphas,
                              num_lookup_columns, ctl_structure, challenges,
                              publics)

    with step(timer, "quotient"):
        qvals = quotient_values(
            stark, degree_bits, trace_commitment.coeffs,
            aux_commitment.coeffs, alphas, num_lookup_columns,
            ctl_structure, challenges, publics, comm,
            (trace_commitment.col_counts, aux_commitment.col_counts))

    with step(timer, "quotient_commit"):
        quot_counts = None
        if comm is not None:
            quot_counts = [2 * c for c in split_counts(len(qvals),
                                                       comm.size)]
        quotient_commitment = PolynomialBatch.from_coeffs(
            quotient_chunks(qvals, n, comm), rate_bits, cap_height,
            device=device, mesh=mesh, col_counts=quot_counts)
        challenger.observe_cap(quotient_commitment.cap_u64())

    zeta = challenger.get_extension_challenge()
    # zeta must lie outside H (otherwise Z_H(zeta) = 0)
    assert gl2.host_pow(zeta, n) != (1, 0), "opening point is in the subgroup"

    g = gl.primitive_root_of_unity(degree_bits)
    zeta_next = gl2.host_mul(zeta, (g, 0))

    with step(timer, "openings"):
        (local_values, next_values, aux_open, aux_open_next,
         quotient_open, aux_at_one) = fri_oracle.eval_columns_at_many(
             [(trace_commitment.coeffs, zeta),
              (trace_commitment.coeffs, zeta_next),
              (aux_commitment.coeffs, zeta),
              (aux_commitment.coeffs, zeta_next),
              (quotient_commitment.coeffs, zeta)],
             extra=[gl.sum_axis(aux_commitment.coeffs, -1)], comm=comm,
             counts=[trace_commitment.col_counts] * 2
             + [aux_commitment.col_counts] * 2
             + [quotient_commitment.col_counts, aux_commitment.col_counts])
    total_helpers = sum(ctl_data.num_ctl_helper_polys())
    ctl_zs_first = aux_at_one[num_lookup_columns + total_helpers:]

    openings = StarkOpeningSet(
        local_values=local_values, next_values=next_values,
        auxiliary_polys=aux_open, auxiliary_polys_next=aux_open_next,
        ctl_zs_first=ctl_zs_first, quotient_polys=quotient_open)

    for batch_vals in openings.fri_batches():
        for c0, c1 in batch_vals:
            challenger.observe_extension((int(c0), int(c1)))

    num_columns = trace_commitment.num_polys
    num_aux = aux_commitment.num_polys
    num_quot = quotient_commitment.num_polys
    batches = [
        fri_oracle.OpeningBatch(point=zeta, ranges=(
            fri_oracle.PolyRange(0, 0, num_columns),
            fri_oracle.PolyRange(1, 0, num_aux),
            fri_oracle.PolyRange(2, 0, num_quot))),
        fri_oracle.OpeningBatch(point=zeta_next, ranges=(
            fri_oracle.PolyRange(0, 0, num_columns),
            fri_oracle.PolyRange(1, 0, num_aux))),
        fri_oracle.OpeningBatch(point=(1, 0), ranges=(
            fri_oracle.PolyRange(1, num_lookup_columns + total_helpers,
                                 num_aux),)),
    ]
    oracles = [trace_commitment, aux_commitment, quotient_commitment]
    opening_proof = fri_oracle.open_and_prove(
        batches, openings.fri_batches(), oracles, challenger,
        config.fri_config, timer, comm)

    proof = StarkProof(
        trace_cap=trace_commitment.cap_u64(),
        auxiliary_polys_cap=aux_commitment.cap_u64(),
        quotient_polys_cap=quotient_commitment.cap_u64(),
        openings=openings, opening_proof=opening_proof)
    return StarkProofWithMetadata(
        init_challenger_state=init_challenger_state, proof=proof,
        degree_bits=degree_bits)


def _tp_blocks(traces, mesh):
    """Each whole trace -> (this rank's column shard, its block of rows
    plus the next row), on the mesh's device."""
    tp = mesh.tp_comm.size
    shards, rows = [], []
    for t in traces:
        n = t.shape[-1]
        if n % tp:
            raise ValueError(f"a table of {n} rows does not split over "
                             f"tp={tp}: heights must be divisible by tp")
        b = n // tp
        idx = torch.arange(mesh.tp_index * b, (mesh.tp_index + 1) * b + 1,
                           device=t.device) % n
        shards.append(t[mesh.tp_block(t.shape[0])].to(mesh.device))
        rows.append(t[:, idx].to(mesh.device))
    return shards, rows


def prove_with_traces(starks: Sequence, config: StarkConfig,
                      traces: Sequence[torch.Tensor], ctls,
                      public_values: PublicValues, device=None,
                      timer=None, debug: bool = False,
                      mesh=None) -> AllProof:
    """traces[t]: (C_t, N_t) int64 trace values of table t.

    Runs on the card unless device='cpu' (raises without a card).  `timer`
    (a utils.timing.StepTimer) collects per-step seconds; `debug` checks
    each table's constraints on H before its quotient.  With a tp `mesh`
    (parallel/sharding.py) the proof is spread over its tp group and runs
    on the mesh's device: every rank passes the same whole traces (every
    height divisible by tp) and gets the same proof."""
    comm = tp_group(mesh)
    dev = mesh.device if mesh is not None else resolve_device(device)
    rate_bits = config.fri_config.rate_bits
    cap_height = config.fri_config.cap_height
    if comm is None:
        traces = rows = [t.to(dev) for t in traces]
        counts = [None] * len(traces)
    else:
        if debug:
            raise ValueError("debug=True checks whole traces: prove it "
                             "without a mesh")
        traces, rows = _tp_blocks(traces, mesh)
        counts = [split_counts(t.shape[0], comm.size)
                  for t in rows]

    with step(timer, "trace_commit"):
        trace_commitments = [
            PolynomialBatch.from_values(t, rate_bits, cap_height, device=dev,
                                        mesh=mesh, col_counts=c)
            for t, c in zip(traces, counts)]
        caps = [c.cap_u64() for c in trace_commitments]
    traces = rows
    challenger = Challenger()
    for cap in caps:
        challenger.observe_cap(cap)
    observe_public_values(challenger, public_values)

    ctl_challenges = get_grand_product_challenge_set(
        challenger, config.num_challenges)
    with step(timer, "ctl"):
        ctl_data_per_table = cross_table_lookup_data(
            traces, ctls, ctl_challenges, 3, comm)

    proofs = []
    for i, (stark, commitment) in enumerate(zip(starks, trace_commitments)):
        proofs.append(prove_single_table(
            stark, config, traces[i], commitment, ctl_data_per_table[i],
            ctl_challenges, challenger,
            publics=public_inputs_of(stark, public_values), timer=timer,
            debug=debug, mesh=mesh))
        # this table's commitment, trace and CTL columns are dead now:
        # free them before the next table commits its oracles
        commitment.release()
        traces[i] = None
        ctl_data_per_table[i] = None
    return AllProof(stark_proofs=proofs, ctl_challenges=ctl_challenges,
                    public_values=public_values)
