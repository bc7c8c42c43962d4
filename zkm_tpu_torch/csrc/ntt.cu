// K2: batched radix-2 Goldilocks NTT over (rows, N) u64, N = 2^log_n.
//
// Replaces the XLA-lowered zkm_tpu/field/ntt.py:83 `_core` (and through it
// `ntt`, `intt`, `coset_ntt`, `coset_intt`, `lde`), the reference prover's
// hottest function.  Plain version: `_transform_plain` in
// zkm_tpu_torch/field/ntt.py.
//
// Two kernels, one launch each:
//   bitrev_scale  out[r, i] = x[r, rev(i)] * tab[rev(i)] * factor, where
//                 rev(i) >= n_in reads as 0 (the LDE's zero padding); tab
//                 is the coset shift's powers (or absent), factor 1/N for
//                 an inverse transform.
//   stage         one decimation-in-time stage s, in place: one thread per
//                 butterfly, twiddle w_{2m}^k read from tw[m + k].
// A transform is bitrev_scale + log_n stage launches, each stage reading
// and writing the whole batch from device memory.
//
// Bound: integer operations.  A butterfly is one mul + one add + one sub
// (~36 32-bit ops with goldilocks.cuh's costs); N/2 * log_n butterflies a
// row.  One launch per stage moves 16 bytes per element per stage, so the
// kernels run well above that bound; fusing stages in shared memory is
// later work.
#include <cuda_runtime.h>

#include <cstdint>

#include "goldilocks.cuh"

namespace {

__global__ void bitrev_scale_kernel(const uint64_t* __restrict__ x,
                                    uint64_t* __restrict__ out,
                                    const uint64_t* __restrict__ tab,
                                    uint64_t factor, int64_t rows,
                                    int64_t n_in, int log_n) {
  int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (rows << log_n)) return;
  int64_t r = idx >> log_n;
  uint64_t i = (uint64_t)idx & ((1ull << log_n) - 1);
  int64_t j = log_n ? (int64_t)(__brevll(i) >> (64 - log_n)) : 0;
  uint64_t v = 0;
  if (j < n_in) {
    v = x[r * n_in + j];
    if (tab != nullptr) v = gl::mul(v, tab[j]);
    if (factor != 1) v = gl::mul(v, factor);
  }
  out[idx] = v;
}

__global__ void stage_kernel(uint64_t* __restrict__ x,
                             const uint64_t* __restrict__ tw, int64_t rows,
                             int log_n, int s) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (rows << (log_n - 1))) return;
  int64_t r = t >> (log_n - 1);
  int64_t j = t & ((1ll << (log_n - 1)) - 1);
  int64_t m = 1ll << (s - 1);
  int64_t k = j & (m - 1);
  int64_t i0 = (r << log_n) + ((j >> (s - 1)) << s) + k;
  int64_t i1 = i0 + m;
  uint64_t a = x[i0];
  uint64_t b = gl::mul(x[i1], tw[m + k]);
  x[i0] = gl::add(a, b);
  x[i1] = gl::sub(a, b);
}

constexpr int THREADS = 256;

unsigned blocks_for(int64_t n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

extern "C" {

// x: (rows, n_in) u64, out: (rows, 2^log_n) u64, tab: nullptr or >= n_in.
int zkm_ntt_bitrev_scale(const uint64_t* x, uint64_t* out,
                         const uint64_t* tab, uint64_t factor, int64_t rows,
                         int64_t n_in, int log_n, void* stream) {
  int64_t n = rows << log_n;
  if (n <= 0) return 0;
  bitrev_scale_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      x, out, tab, factor, rows, n_in, log_n);
  return (int)cudaGetLastError();
}

// x: (rows, 2^log_n) u64 in place; tw: 2^log_n twiddles, tw[m + k] =
// w_{2m}^k; 1 <= s <= log_n.
int zkm_ntt_stage(uint64_t* x, const uint64_t* tw, int64_t rows, int log_n,
                  int s, void* stream) {
  int64_t n = rows << (log_n - 1);
  if (n <= 0) return 0;
  stage_kernel<<<blocks_for(n), THREADS, 0, (cudaStream_t)stream>>>(
      x, tw, rows, log_n, s);
  return (int)cudaGetLastError();
}

const char* zkm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
