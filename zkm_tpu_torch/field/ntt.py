"""Number-theoretic transforms (radix-2) over Goldilocks, batched.

Counterpart of `zkm_tpu/field/ntt.py`.  A batch of polynomials is an int64
tensor (..., N) with the coefficient/evaluation axis last.  Subgroup
convention matches plonky2: the size-N subgroup is generated by
POWER_OF_TWO_GENERATOR^(2^(32 - log2 N)); cosets are shifted by the
multiplicative generator g = 7.

Every transform is one call of `transform` (`coset_intt` then scales its
output by the shift's inverse powers):
    out = NTT_N(zero_pad(x) * scale) * factor
with decimation in time (bit-reversed input order, natural output).  On a
CUDA tensor that is kernel K2 (`csrc/ntt.cu`), in the passes `plan` gives;
on a CPU tensor it is the plain version `_transform_plain`, which does the
same arithmetic.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import torch

from .. import native
from . import goldilocks as gl


# K2's launch count: every kernel launch below adds one.
LAUNCHES = 0

# K2 runs a transform in passes of at most MAX_STAGES radix-2 stages, each
# on tiles of at most 2^LOG_TILE values (64 KB of shared memory) that take
# up to 2^LOG_COLS columns side by side (64-byte runs in device memory).
# The shared-memory budget is set here only: `csrc/ntt.cu` launches the
# tiles it is given, and one larger than the card allows fails at launch.
MAX_STAGES = 11
LOG_TILE = 13
LOG_COLS = 3


def plan(log_n: int) -> list[tuple[int, int, int]]:
    """K2's passes for a size-2^log_n transform, (first_stage, stages,
    log_cols) each: stages 1..log_n once each, in as few passes as
    MAX_STAGES allows, split evenly.  A pass works on tiles of
    2^(stages + log_cols) values: 2^log_cols columns (chunks in the first
    pass, consecutive low positions in a later one), as many as the
    transform has, up to LOG_COLS and the tile's LOG_TILE."""
    n_passes = max(1, -(-log_n // MAX_STAGES))
    passes, done = [], 0
    for left in range(n_passes, 0, -1):
        stages = -(-(log_n - done) // left)
        cols = log_n - stages if done == 0 else done
        passes.append((done + 1, stages,
                       min(LOG_COLS, LOG_TILE - stages, cols)))
        done += stages
    return passes


@lru_cache(maxsize=64)
def bit_reverse_tensor(log_n: int, device: torch.device) -> torch.Tensor:
    """rev[i] = i with its log_n bits reversed, built on `device` by
    doubling: rev_{k+1} = [2 rev_k, 2 rev_k + 1]."""
    rev = torch.zeros(1, dtype=torch.int64, device=device)
    for _ in range(log_n):
        rev = torch.cat([2 * rev, 2 * rev + 1])
    return rev


@lru_cache(maxsize=64)
def twiddles(log_n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """All stages' twiddles in one table, built on `device`: tw[m + k] =
    w_{2m}^k for the stage of half-size m (w inverted for the inverse
    transform)."""
    n = 1 << log_n
    tw = torch.ones(max(n, 1), dtype=torch.int64, device=device)
    if log_n:
        root = gl.primitive_root_of_unity(log_n)
        if inverse:
            root = gl.host_inv(root)
        pw = gl.powers(root, n // 2, device)
        m = 1
        while m < n:
            tw[m:2 * m] = pw[::n // (2 * m)][:m]
            m *= 2
    return tw


@lru_cache(maxsize=64)
def shift_powers(n: int, shift: int, invert: bool,
                 device: torch.device) -> torch.Tensor:
    if invert:
        shift = gl.host_inv(shift)
    return gl.powers(shift, n, device)


def _transform_plain(x: torch.Tensor, log_n: int, inverse: bool,
                     scale: Optional[torch.Tensor], factor: int) -> torch.Tensor:
    """Plain-torch version of K2 on (rows, n_in) -> (rows, 2^log_n)."""
    rows, n_in = x.shape
    n = 1 << log_n
    v = x
    if scale is not None:
        v = gl.mul(v, scale[:n_in])
    if factor != 1:
        v = gl.mul(v, factor)
    if n_in < n:
        v = torch.cat([v, v.new_zeros(rows, n - n_in)], dim=1)
    v = v.index_select(1, bit_reverse_tensor(log_n, x.device))
    tw = twiddles(log_n, inverse, x.device)
    for s in range(1, log_n + 1):
        m = 1 << (s - 1)
        v = v.view(rows, n // (2 * m), 2, m)
        a = v[:, :, 0]
        b = gl.mul(v[:, :, 1], tw[m:2 * m])
        v = torch.stack([gl.add(a, b), gl.sub(a, b)], dim=2).view(rows, n)
    return v


def _transform_cuda(x: torch.Tensor, log_n: int, inverse: bool,
                    scale: Optional[torch.Tensor], factor: int) -> torch.Tensor:
    global LAUNCHES
    lib = native.library("ntt")
    rows, n_in = x.shape
    x = x.contiguous()
    out = torch.empty((rows, 1 << log_n), dtype=torch.int64, device=x.device)
    if rows == 0:
        return out
    if scale is not None:
        _check_table(scale, x, n_in)
        scale = scale.contiguous()
    tw = twiddles(log_n, inverse, x.device)
    stream = native.stream_ptr(x.device)
    # the launches go to the current device: make it the tensor's
    with torch.cuda.device(x.device):
        for first, stages, log_cols in plan(log_n):
            if first == 1:
                err = lib.zkm_ntt_first_pass(
                    x.data_ptr(), out.data_ptr(),
                    scale.data_ptr() if scale is not None else None,
                    factor % gl.P, tw.data_ptr(), rows, n_in, log_n, stages,
                    log_cols, stream)
            else:
                err = lib.zkm_ntt_pass(
                    out.data_ptr(), tw.data_ptr(), rows, log_n, first,
                    stages, log_cols, stream)
            native.check(lib, err, f"ntt pass from stage {first}")
            LAUNCHES += 1
    return out


def _check_table(tab: torch.Tensor, x: torch.Tensor, n: int) -> None:
    if tab.dtype != torch.int64 or tab.device != x.device or tab.numel() < n:
        raise ValueError(f"table must be int64 on {x.device} with >= {n} "
                         f"values, got {tab.dtype} on {tab.device}, "
                         f"{tab.numel()} values")


def transform(x: torch.Tensor, log_n: int, inverse: bool = False,
              scale: Optional[torch.Tensor] = None,
              factor: int = 1) -> torch.Tensor:
    """NTT_N(zero_pad(x) * scale) * factor over the last axis, N = 2^log_n.

    x: (..., n_in) with n_in <= N; scale indexes x's (natural) order."""
    if x.dtype != torch.int64:
        raise TypeError(f"expected an int64 tensor, got {x.dtype}")
    lead, n_in = x.shape[:-1], x.shape[-1]
    if n_in > (1 << log_n):
        raise ValueError(f"{n_in} values do not fit a size-2^{log_n} NTT")
    x2 = x.reshape(-1, n_in)
    if x.is_cuda:
        out = _transform_cuda(x2, log_n, inverse, scale, factor)
    elif x.device.type == "cpu":
        out = _transform_plain(x2, log_n, inverse, scale, factor)
    else:
        raise ValueError(f"unsupported device {x.device}")
    return out.view(*lead, 1 << log_n)


def _log2(n: int) -> int:
    assert n & (n - 1) == 0 and n > 0, n
    return n.bit_length() - 1


def ntt(coeffs: torch.Tensor) -> torch.Tensor:
    """Coefficients -> evaluations over the subgroup (natural order)."""
    return transform(coeffs, _log2(coeffs.shape[-1]))


def intt(evals: torch.Tensor) -> torch.Tensor:
    """Evaluations -> coefficients."""
    n = evals.shape[-1]
    return transform(evals, _log2(n), inverse=True, factor=gl.host_inv(n))


def coset_ntt(coeffs: torch.Tensor, shift: int = gl.GENERATOR) -> torch.Tensor:
    """Evaluate p(shift * x) over the subgroup."""
    n = coeffs.shape[-1]
    return transform(coeffs, _log2(n),
                     scale=shift_powers(n, shift, False, coeffs.device))


def coset_intt(evals: torch.Tensor, shift: int = gl.GENERATOR) -> torch.Tensor:
    """Inverse of coset_ntt: the shift's inverse powers scale the output,
    which `transform` does not do, so that multiply stays plain torch."""
    n = evals.shape[-1]
    return gl.mul(intt(evals), shift_powers(n, shift, True, evals.device))


def lde(coeffs: torch.Tensor, rate_bits: int,
        shift: int = gl.GENERATOR) -> torch.Tensor:
    """Low-degree extension: zero-pad coeffs by 2^rate_bits and evaluate on
    shift * <subgroup of size N * 2^rate> (natural order)."""
    n = coeffs.shape[-1]
    return transform(coeffs, _log2(n) + rate_bits,
                     scale=shift_powers(n, shift, False, coeffs.device))
