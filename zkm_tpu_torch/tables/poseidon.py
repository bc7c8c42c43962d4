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
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..convert import from_u64, to_u64
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


def _consts(values) -> torch.Tensor:
    """Nested lists of python ints -> a field tensor of the same shape."""
    arr = np.array(values, dtype=object)
    return gl.from_ints(arr.reshape(-1)).reshape(arr.shape)


def _matmul(state: torch.Tensor, matrix) -> torch.Tensor:
    """(k, n) field elements times the (m, n) constant matrix -> (k, m)."""
    return gl.sum_axis(gl.mul(state[:, None, :], _consts(matrix)[None]), -1)


def _sbox(x: torch.Tensor):
    """(x^3, x^7), the two committed witnesses of one S-box."""
    x3 = gl.mul(gl.square(x), x)
    return x3, gl.mul(gl.square(x3), x)


def _perm_rows(inputs: np.ndarray, timestamps: np.ndarray) -> np.ndarray:
    """(k, 12) u64 permutation inputs -> (k, NUM_COLUMNS) u64 rows with
    filter 1: the reference's `_perm_row` for every row at once."""
    k = inputs.shape[0]
    out = torch.zeros((k, NUM_COLUMNS), dtype=torch.int64)
    state = from_u64(inputs.reshape(k, WIDTH))
    out[:, FILTER] = 1
    out[:, TIMESTAMP] = from_u64(timestamps)
    out[:, START_IN:START_IN + WIDTH] = state
    rc = _consts(C.ALL_ROUND_CONSTANTS).reshape(C.N_ROUNDS, WIDTH)

    def full_rounds(state, round_ctr, start):
        for r in range(HALF_FULL):
            x3, x7 = _sbox(gl.add(state, rc[round_ctr + r]))
            base = start + WIDTH * 2 * r
            out[:, base:base + 2 * WIDTH:2] = x3
            out[:, base + 1:base + 2 * WIDTH:2] = x7
            state = _matmul(x7, _MDS)
        return state

    state = full_rounds(state, 0, START_FULL_0)
    state = gl.add(state, _consts(_FAST["first_round_constant"]))
    state = torch.cat([state[:, :1], _matmul(state[:, 1:], _INITIAL_T)], 1)
    w_hats, vs = _consts(_FAST["w_hats"]), _consts(_FAST["vs"])
    for r in range(N_PARTIAL):
        x3, s0 = _sbox(state[:, 0])
        out[:, reg_partial_s0(r)] = x3
        out[:, reg_partial_s1(r)] = s0
        if r < N_PARTIAL - 1:
            s0 = gl.add(s0, _FAST["round_constants"][r])
        rest = state[:, 1:]
        d = gl.add(gl.mul(s0, _MDS0TO0),
                   gl.sum_axis(gl.mul(rest, w_hats[r]), -1))
        state = torch.cat([d[:, None],
                           gl.add(rest, gl.mul(s0[:, None], vs[r]))], 1)
    state = full_rounds(state, HALF_FULL + N_PARTIAL, START_FULL_1)
    out[:, START_OUT:START_OUT + WIDTH] = state
    return to_u64(out)


def generate_rows(perms: Sequence[Tuple[List[int], int]],
                  min_rows: int = 64) -> np.ndarray:
    """perms: (12 input elements, timestamp) pairs -> (NUM_COLUMNS, N) u64.

    Padding rows are *complete* zero-input permutation rows with filter=0
    (the ungated round constraints must hold on every row — reference
    poseidon_stark.rs:121-126)."""
    n = max(len(perms), min_rows, 2)
    n = 1 << (n - 1).bit_length()
    rows = np.zeros((n, NUM_COLUMNS), dtype=np.uint64)
    if len(perms):
        inputs = np.array([[int(x) % P for x in inp] for inp, _ in perms],
                          dtype=np.uint64)
        stamps = np.array([int(ts) for _, ts in perms], dtype=np.uint64)
        rows[:len(perms)] = _perm_rows(inputs, stamps)
    if len(perms) < n:
        default = _perm_rows(np.zeros((1, WIDTH), np.uint64),
                             np.zeros(1, np.uint64))[0]
        default[FILTER] = 0
        rows[len(perms):] = default
    return rows.T.copy()


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
