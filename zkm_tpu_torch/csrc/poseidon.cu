// K1: the width-12 Goldilocks Poseidon permutation, one thread per state.
//
// Replaces the Pallas kernel zkm_tpu/ops/pallas_poseidon.py:104
// `permute_cols_pallas` (body `_kernel` :96 -> `_permute_cols` :76,
// `_sbox` :70, `_mds_cols` :41): 4 full + 22 partial + 4 full rounds,
// S-box x^7, circulant MDS [17,15,41,16,2,28,13,13,39,18,34,20] plus 8 on
// the (0,0) diagonal.  Plain version: `_permute_plain` in
// zkm_tpu_torch/hash/poseidon.py.
//
// Layout: states are (B, 12) row-major u64; each thread keeps its 12 lanes
// in registers for all 30 rounds and touches device memory twice (96 bytes
// in, 96 bytes out).  The TPU kernel's (12, B) sublane layout and its
// 512-state tiles are not carried over: any B runs, the ragged tail is a
// bounds check.  Round constants live in __constant__ memory (every thread
// of a warp reads the same constant, so the read is a broadcast).
//
// Bound: integer operations.  Per permutation, counted from this source
// with the costs in goldilocks.cuh: a full round is 12 adds + 48 muls
// (S-boxes) + the MDS (12 rows x 12 terms x 2 32x32 multiply-adds, plus a
// 128-bit recombination and one reduce per row, ~ 12 x 60); a partial
// round is 12 adds + 4 muls + the MDS.  OPS_PER_PERMUTATION below is that
// sum; the wrapper divides it by the card's INT32 rate for its bound.
#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int WIDTH = 12;
constexpr int HALF_FULL = 4;
constexpr int PARTIAL = 22;
constexpr int ROUNDS = 30;

__constant__ uint64_t RC[ROUNDS * WIDTH];

constexpr uint64_t DIAG0 = 8;

constexpr int MDS_OPS = WIDTH * 60;
constexpr int FULL_OPS = WIDTH * gl::ADD_OPS + 4 * WIDTH * gl::MUL_OPS + MDS_OPS;
constexpr int PARTIAL_OPS = WIDTH * gl::ADD_OPS + 4 * gl::MUL_OPS + MDS_OPS;

__device__ __forceinline__ uint64_t sbox(uint64_t x) {
  uint64_t x2 = gl::mul(x, x);
  uint64_t x4 = gl::mul(x2, x2);
  uint64_t x6 = gl::mul(x4, x2);
  return gl::mul(x6, x);
}

// out[r] = sum_i CIRC[i] * s[(r + i) % 12] (+ DIAG0 * s[0] for r = 0).
// The 32-bit halves are summed separately (each sum < 2^41), recombined
// into 128 bits and reduced once per row.
__device__ __forceinline__ void mds(uint64_t s[WIDTH]) {
  constexpr uint64_t CIRC[WIDTH] = {17, 15, 41, 16, 2, 28,
                                    13, 13, 39, 18, 34, 20};
  uint64_t out[WIDTH];
#pragma unroll
  for (int r = 0; r < WIDTH; ++r) {
    uint64_t lo_sum = 0, hi_sum = 0;
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) {
      uint64_t v = s[(r + i) % WIDTH];
      lo_sum += CIRC[i] * (v & 0xFFFFFFFFull);
      hi_sum += CIRC[i] * (v >> 32);
    }
    if (r == 0) {
      lo_sum += DIAG0 * (s[0] & 0xFFFFFFFFull);
      hi_sum += DIAG0 * (s[0] >> 32);
    }
    uint64_t lo = lo_sum + (hi_sum << 32);
    uint64_t hi = (hi_sum >> 32) + (lo < lo_sum ? 1 : 0);
    out[r] = gl::reduce128(lo, hi);
  }
#pragma unroll
  for (int r = 0; r < WIDTH; ++r) s[r] = out[r];
}

__device__ __forceinline__ void full_round(uint64_t s[WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = sbox(gl::add(s[i], RC[r * WIDTH + i]));
  mds(s);
}

__device__ __forceinline__ void partial_round(uint64_t s[WIDTH], int r) {
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = gl::add(s[i], RC[r * WIDTH + i]);
  s[0] = sbox(s[0]);
  mds(s);
}

__global__ void permute_kernel(const uint64_t* __restrict__ in,
                               uint64_t* __restrict__ out, int64_t n) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  uint64_t s[WIDTH];
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) s[i] = in[t * WIDTH + i];
#pragma unroll 1
  for (int r = 0; r < HALF_FULL; ++r) full_round(s, r);
#pragma unroll 1
  for (int r = HALF_FULL; r < HALF_FULL + PARTIAL; ++r) partial_round(s, r);
#pragma unroll 1
  for (int r = HALF_FULL + PARTIAL; r < ROUNDS; ++r) full_round(s, r);
#pragma unroll
  for (int i = 0; i < WIDTH; ++i) out[t * WIDTH + i] = s[i];
}

}  // namespace

extern "C" {

int zkm_poseidon_ops_per_permutation() {
  return 2 * HALF_FULL * FULL_OPS + PARTIAL * PARTIAL_OPS;
}

// Copy the 30 x 12 round constants (host u64) to the current device.
int zkm_poseidon_init(const uint64_t* round_constants) {
  return (int)cudaMemcpyToSymbol(RC, round_constants, sizeof(RC));
}

// in, out: (n, 12) u64 on the device; in == out is allowed.
int zkm_poseidon_permute(const uint64_t* in, uint64_t* out, int64_t n,
                         void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  permute_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      in, out, n);
  return (int)cudaGetLastError();
}

const char* zkm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
