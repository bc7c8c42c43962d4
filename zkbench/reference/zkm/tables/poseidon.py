# Frozen copy of zkm_tpu_torch/tables/poseidon.py at commit 8cde39b, part of the
# benchmark's plain reference (zkbench/reference). Cut down: see the lines marked `frozen:`.
"""Poseidon table: one row per width-12 permutation.

Copy of zkm_tpu/tables/poseidon.py (zkMIPS
prover/src/poseidon/poseidon_stark.rs): columns filter, 12 inputs, 12
outputs, timestamp, then per-sbox witness pairs (s0 = x^3, s1 = x^7) for
the 2x4 full-round layers and 22 partial rounds (NUM_COLUMNS = 262).
Constraints replay the *fast* partial-round evaluation (FAST_PARTIAL_*
matrices) so every step is degree <= 3 given the committed sbox witnesses.

The row builder is vectorized over rows (plain torch field arithmetic on
the CPU) where the reference loops over python ints row by row; both give
the same rows.  Serves the PoseidonSponge table's permutation CTLs.
"""

from __future__ import annotations

import json
import os
from typing import List

import torch

from ..field import goldilocks as gl
from ..hash import poseidon_constants as C
from ..stark.columns import Column, Filter
from ..stark.stark import Stark

P = gl.P
WIDTH = 12
HALF_FULL = C.HALF_N_FULL_ROUNDS   # 4
N_PARTIAL = C.N_PARTIAL_ROUNDS     # 22

with open(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "hash",
        "poseidon_fast_constants.json")) as _f:
    _FAST = json.load(_f)

FILTER = 0
START_IN = 1
START_OUT = START_IN + WIDTH
TIMESTAMP = START_OUT + WIDTH
START_FULL_0 = TIMESTAMP + 1


def reg_in(i):
    return START_IN + i


def reg_out(i):
    return START_OUT + i


def reg_full0_s0(r, i):
    return START_FULL_0 + WIDTH * 2 * r + 2 * i


def reg_full0_s1(r, i):
    return reg_full0_s0(r, i) + 1


START_PARTIAL = START_FULL_0 + WIDTH * 2 * HALF_FULL


def reg_partial_s0(r):
    return START_PARTIAL + r * 2


def reg_partial_s1(r):
    return reg_partial_s0(r) + 1


START_FULL_1 = START_PARTIAL + N_PARTIAL * 2


def reg_full1_s0(r, i):
    return START_FULL_1 + WIDTH * 2 * r + 2 * i


def reg_full1_s1(r, i):
    return reg_full1_s0(r, i) + 1


NUM_COLUMNS = START_FULL_1 + WIDTH * 2 * HALF_FULL  # 262

_MDS0TO0 = C.MDS_MATRIX_CIRC[0] + C.MDS_MATRIX_DIAG[0]

# ---------------------------------------------------------------------------
# Trace generation (mirrors generate_trace_rows_for_perm, all rows at once).
# ---------------------------------------------------------------------------

# out[i] = sum_k MDS[i][k] * state[k]: the circulant plus its diagonal
_MDS = [[C.MDS_MATRIX_CIRC[(k - i) % WIDTH]
         + (C.MDS_MATRIX_DIAG[i] if k == i else 0) for k in range(WIDTH)]
        for i in range(WIDTH)]
# new[1 + c] = sum_r state[1 + r] * initial_matrix[r][c]
_INITIAL_T = [list(col) for col in zip(*_FAST["initial_matrix"])]


# frozen: left out, as only the prover uses them: _consts, _matmul,
# _perm_rows, generate_rows.


def _sbox(x: torch.Tensor):
    """(x^3, x^7), the two committed witnesses of one S-box."""
    x3 = gl.mul(gl.square(x), x)
    return x3, gl.mul(gl.square(x3), x)


def ctl_data_inputs() -> List[Column]:
    cols = Column.singles([reg_in(i) for i in range(WIDTH)])
    cols.append(Column.single(TIMESTAMP))
    return cols


def ctl_data_outputs() -> List[Column]:
    cols = Column.singles([reg_out(i) for i in range(WIDTH)])
    cols.append(Column.single(TIMESTAMP))
    return cols


def ctl_filter() -> Filter:
    return Filter.new_simple(Column.single(FILTER))


class PoseidonStark(Stark):
    num_columns = NUM_COLUMNS

    def eval_generic(self, a, lv, nv, consumer):
        state = [lv[reg_in(i)] for i in range(WIDTH)]
        rc = C.ALL_ROUND_CONSTANTS
        round_ctr = 0

        def sbox(x, s0_col, s1_col):
            inter = lv[s0_col]
            out = lv[s1_col]
            consumer.constraint(a.sub(a.mul(a.mul(x, x), x), inter))
            consumer.constraint(a.sub(a.mul(a.mul(x, inter), inter), out))
            return out

        for r in range(HALF_FULL):
            state = [a.add_const(s, rc[i + WIDTH * round_ctr])
                     for i, s in enumerate(state)]
            state = [sbox(state[i], reg_full0_s0(r, i), reg_full0_s1(r, i))
                     for i in range(WIDTH)]
            state = self._mds(a, state)
            round_ctr += 1

        state = [a.add_const(s, _FAST["first_round_constant"][i])
                 for i, s in enumerate(state)]
        new = [a.zero] * WIDTH
        new[0] = state[0]
        for rr in range(1, WIDTH):
            for cc in range(1, WIDTH):
                new[cc] = a.add(new[cc], a.mul_const(
                    state[rr], _FAST["initial_matrix"][rr - 1][cc - 1]))
        state = new
        for r in range(N_PARTIAL):
            state[0] = sbox(state[0], reg_partial_s0(r), reg_partial_s1(r))
            if r < N_PARTIAL - 1:
                state[0] = a.add_const(state[0], _FAST["round_constants"][r])
            d = a.mul_const(state[0], _MDS0TO0)
            for i in range(1, WIDTH):
                d = a.add(d, a.mul_const(state[i], _FAST["w_hats"][r][i - 1]))
            new = [d]
            for i in range(1, WIDTH):
                new.append(a.add(state[i], a.mul_const(
                    state[0], _FAST["vs"][r][i - 1])))
            state = new
        round_ctr += N_PARTIAL

        for r in range(HALF_FULL):
            state = [a.add_const(s, rc[i + WIDTH * round_ctr])
                     for i, s in enumerate(state)]
            state = [sbox(state[i], reg_full1_s0(r, i), reg_full1_s1(r, i))
                     for i in range(WIDTH)]
            state = self._mds(a, state)
            round_ctr += 1

        for i in range(WIDTH):
            consumer.constraint(a.sub(state[i], lv[reg_out(i)]))

    @staticmethod
    def _mds(a, state):
        out = []
        for i in range(WIDTH):
            acc = a.mul_const(state[i], C.MDS_MATRIX_DIAG[i])
            for j in range(WIDTH):
                acc = a.add(acc, a.mul_const(state[(j + i) % WIDTH],
                                             C.MDS_MATRIX_CIRC[j]))
            out.append(acc)
        return out
