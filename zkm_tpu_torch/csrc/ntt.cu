// K2: batched radix-2 Goldilocks NTT over (rows, N) u64, N = 2^log_n.
//
// Replaces the XLA-lowered zkm_tpu/field/ntt.py:83 `_core` (and through it
// `ntt`, `intt`, `coset_ntt`, `coset_intt`, `lde`), the reference prover's
// hottest function.  Plain version: `_transform_plain` in
// zkm_tpu_torch/field/ntt.py, which also holds `plan`, the passes below.
//
// It computes out = NTT_N(zero_pad(x) * scale) * factor by decimation in
// time (bit-reversed input order, natural output), in a few passes that
// each run several radix-2 stages on tiles held in shared memory:
//   first pass  stages 1..S.  After bit reversal, stages 1..S stay inside
//               contiguous chunks of 2^S positions, and chunk h holds the
//               inputs x[j * 2^(log_n - S) + rev(h)], j < 2^S: a strided
//               column.  A block takes 2^g such columns side by side (one
//               64-byte or 32-byte run per j), reads 0 past n_in (the LDE's
//               zero padding), multiplies by scale and factor, runs the S
//               stages and writes each chunk contiguously.
//   pass        stages k0+1..k0+S in place.  A block takes the 2^S
//               positions that differ in bits k0..k0+S-1, times 2^g
//               consecutive low positions.
// In the first pass, the stages that only copy zero padding (z of them
// when n_in <= N / 2^z) become copies made while loading.  Inside a tile a
// thread takes 8 values into registers and runs up to 3 stages on them
// (12 butterflies) between two __syncthreads: one round trip through
// shared memory per 3 stages, in blocks of at most 512 threads.  The
// twiddle of global stage s at position i is tw[M + (i mod M)], M =
// 2^(s-1); inside a later pass it depends on the tile's low positions, so
// each butterfly reads it from the global table (L2-resident up to 16 MB).
// Copying a tile's twiddles into shared memory first was slower.  The tile
// budget is `plan`'s alone: a kernel may take up to the card's opt-in
// maximum of dynamic shared memory, and a larger tile fails at launch.
//
// Bound: integer operations.  A butterfly is one mul + one add + one sub
// (~36 32-bit ops with goldilocks.cuh's costs), N/2 * log_n of them a row
// less the z stages that only copy padding, and a scaling multiply is ~26.  The old design, one launch per stage,
// moved 16 bytes per value per stage through device memory and ran at ~5x
// that bound; here a transform of log_n <= 22 is two launches, so device
// memory sees each value about four times.  Every value written to device
// or shared memory is canonical, so any butterfly order gives the plain
// version's bits.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

#include "goldilocks.cuh"

namespace {

constexpr int LOG_EPT = 3;        // a thread holds 2^LOG_EPT values a round
constexpr int EPT = 1 << LOG_EPT;
constexpr int MAX_THREADS = 512;  // two blocks an SM at 64 registers
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ uint32_t rev_bits(uint32_t x, int bits) {
  return bits ? __brev(x) >> (32 - bits) : 0;
}

// A tile in shared memory: sh[r << g | col] for the 2^S positions r along
// the stages and 2^g columns.  Tile stage q (1..S) pairs r with r + 2^(q-1)
// and multiplies by tw[((2^(q-1) + r mod 2^(q-1)) << k0) + lo + (col &
// col_mask)]: k0 stages came before, lo is the position of column 0 in a
// later pass (0 in the first, where col_mask is 0 too).
struct Tile {
  uint64_t* sh;
  const uint64_t* tw;  // the transform's table, tw[m + k] = w_{2m}^k
  int S, g, k0;
  uint32_t lo, col_mask;
};

__device__ __forceinline__ uint64_t twiddle(const Tile& t, uint32_t idx,
                                            uint32_t col) {
  return __ldg(t.tw + (idx << t.k0) + t.lo + (col & t.col_mask));
}

// Tile stages p+1..p+B: the threads walk the tile's groups of 2^B values
// that differ in the tile index bits g+p..g+p+B-1, one group at a time.
template <int B>
__device__ __forceinline__ void radix_round(const Tile& t, int p) {
  constexpr int U = 1 << B;
  const int sb = t.g + p;
  const uint32_t groups = 1u << (t.S + t.g - B);
  for (uint32_t gid = threadIdx.x; gid < groups; gid += blockDim.x) {
    const uint32_t base = ((gid >> sb) << (sb + B)) | (gid & ((1u << sb) - 1));
    const uint32_t col = base & ((1u << t.g) - 1);
    const uint32_t rlow = (base >> t.g) & ((1u << p) - 1);
    uint64_t v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = t.sh[base + (u << sb)];
#pragma unroll
    for (int d = 0; d < B; ++d) {
      uint64_t w[U / 2];
#pragma unroll
      for (int lu = 0; lu < (1 << d); ++lu)
        w[lu] = twiddle(t, (1u << (p + d)) + rlow + (lu << p), col);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u & (1 << d)) continue;
        uint64_t a = v[u];
        uint64_t b = gl::mul(v[u + (1 << d)], w[u & ((1 << d) - 1)]);
        v[u] = gl::add(a, b);
        v[u + (1 << d)] = gl::sub(a, b);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) t.sh[base + (u << sb)] = v[u];
  }
}

// Tile stages from+1..S of a loaded tile, in rounds of at most LOG_EPT
// stages split evenly; returns after a __syncthreads.
__device__ void run_stages(const Tile& t, int from) {
  for (int p = from, left = (t.S - from + LOG_EPT - 1) / LOG_EPT; left > 0;
       --left) {
    int b = (t.S - p + left - 1) / left;
    if (b == 3) {
      radix_round<3>(t, p);
    } else if (b == 2) {
      radix_round<2>(t, p);
    } else {
      radix_round<1>(t, p);
    }
    __syncthreads();
    p += b;
  }
}

__global__ void __launch_bounds__(MAX_THREADS, 2)
first_pass_kernel(const uint64_t* __restrict__ x, uint64_t* __restrict__ out,
                  const uint64_t* __restrict__ scale, uint64_t factor,
                  const uint64_t* __restrict__ tw, int64_t rows,
                  int64_t n_in, int log_n, int S, int g) {
  extern __shared__ uint64_t sh[];
  const uint32_t tile = 1u << (S + g), cols = 1u << g, R = 1u << S;
  const uint32_t c0 = blockIdx.x << g;
  const int rest = log_n - S;  // log2 of the stride of a chunk's inputs
  // n_in <= N / 2^z: the inputs j >= 2^(S - z) of a chunk are padding, so
  // stages 1..z only copy each value at r = rev(j) to r + 1..r + 2^z - 1.
  int z = 0;
  while (z < S && (n_in << (z + 1)) <= (1ll << log_n)) ++z;
  const Tile t{sh, tw, S, g, 0, 0, 0};
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const uint64_t* xr = x + row * n_in;
    for (uint32_t f = threadIdx.x; f < tile >> z; f += blockDim.x) {
      uint32_t j = f >> g, col = f & (cols - 1);
      int64_t idx = ((int64_t)j << rest) + c0 + col;
      uint64_t v = 0;
      if (idx < n_in) {
        v = xr[idx];
        if (scale != nullptr) v = gl::mul(v, scale[idx]);
        if (factor != 1) v = gl::mul(v, factor);
      }
      uint32_t r = rev_bits(j, S);
      for (uint32_t u = 0; u < 1u << z; ++u) sh[((r + u) << g) | col] = v;
    }
    __syncthreads();
    run_stages(t, z);
    uint64_t* o = out + (row << log_n);
    for (uint32_t f = threadIdx.x; f < tile; f += blockDim.x) {
      uint32_t col = f >> S, r = f & (R - 1);
      o[((uint64_t)rev_bits(c0 + col, rest) << S) + r] = sh[(r << g) | col];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(MAX_THREADS, 2)
pass_kernel(uint64_t* __restrict__ x, const uint64_t* __restrict__ tw,
            int64_t rows, int log_n, int k0, int S, int g) {
  extern __shared__ uint64_t sh[];
  const uint32_t tile = 1u << (S + g), cols = 1u << g;
  const int lb = k0 - g;  // log2 of the tiles along the low positions
  const uint32_t lo = (blockIdx.x & ((1u << lb) - 1)) << g;
  const uint64_t start = ((uint64_t)(blockIdx.x >> lb) << (k0 + S)) + lo;
  const Tile t{sh, tw, S, g, k0, lo, cols - 1};
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    uint64_t* xr = x + (row << log_n) + start;
    for (uint32_t f = threadIdx.x; f < tile; f += blockDim.x)
      sh[f] = xr[((uint64_t)(f >> g) << k0) + (f & (cols - 1))];
    __syncthreads();
    run_stages(t, 0);
    for (uint32_t f = threadIdx.x; f < tile; f += blockDim.x)
      xr[((uint64_t)(f >> g) << k0) + (f & (cols - 1))] = sh[f];
    __syncthreads();
  }
}

// Grid, block and shared memory of a pass over tiles of 2^(S + g) values.
struct Launch {
  dim3 grid, block;
  size_t smem;
};

// Fills `l`; returns 0 or the CUDA error that makes the launch impossible.
// At the first launch of `kernel` on a device (a bit of `allowed_on` each)
// it lets the kernel take the card's opt-in maximum of shared memory.
int launch_shape(const void* kernel, std::atomic<uint64_t>* allowed_on,
                 int64_t rows, int64_t log_n, int64_t S, int64_t g,
                 Launch* l) {
  if (S < 0 || g < 0 || S + g > log_n) return (int)cudaErrorInvalidValue;
  int dev, max_smem;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const uint64_t bit = dev < 64 ? 1ull << dev : 0;
  if (!bit || !(allowed_on->load() & bit)) {
    err = cudaDeviceGetAttribute(&max_smem,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (err != cudaSuccess) return (int)err;
    allowed_on->fetch_or(bit);
  }
  int64_t tile = 1ll << (S + g);
  l->grid = dim3((unsigned)(1ll << (log_n - S - g)),
                 (unsigned)(rows < MAX_GRID_Y ? rows : MAX_GRID_Y));
  int64_t threads = tile / EPT;
  l->block = dim3((unsigned)(threads < 1 ? 1
                             : threads > MAX_THREADS ? MAX_THREADS : threads));
  l->smem = (size_t)tile * sizeof(uint64_t);
  return 0;
}

}  // namespace

extern "C" {

// Stages 1..stages of the transform, with bit reversal, zero padding and
// scaling.  x: (rows, n_in) u64, out: (rows, 2^log_n) u64, scale: nullptr
// or >= n_in values, tw: the transform's 2^log_n twiddles, tw[m + k] =
// w_{2m}^k; a block takes 2^log_cols chunks.
int zkm_ntt_first_pass(const uint64_t* x, uint64_t* out,
                       const uint64_t* scale, uint64_t factor,
                       const uint64_t* tw, int64_t rows, int64_t n_in,
                       int64_t log_n, int64_t stages, int64_t log_cols,
                       void* stream) {
  if (rows <= 0) return 0;
  static std::atomic<uint64_t> allowed_on{0};
  Launch l;
  int err = launch_shape((const void*)first_pass_kernel, &allowed_on, rows,
                         log_n, stages, log_cols, &l);
  if (err) return err;
  first_pass_kernel<<<l.grid, l.block, l.smem, (cudaStream_t)stream>>>(
      x, out, scale, factor, tw, rows, n_in, (int)log_n, (int)stages,
      (int)log_cols);
  return (int)cudaGetLastError();
}

// Stages first_stage..first_stage+stages-1 of x: (rows, 2^log_n) u64 in
// place; a block takes 2^log_cols consecutive low positions, log_cols <
// first_stage.
int zkm_ntt_pass(uint64_t* x, const uint64_t* tw, int64_t rows,
                 int64_t log_n, int64_t first_stage, int64_t stages,
                 int64_t log_cols, void* stream) {
  if (rows <= 0) return 0;
  if (log_cols >= first_stage || first_stage - 1 + stages > log_n)
    return (int)cudaErrorInvalidValue;
  static std::atomic<uint64_t> allowed_on{0};
  Launch l;
  int err = launch_shape((const void*)pass_kernel, &allowed_on, rows, log_n,
                         stages, log_cols, &l);
  if (err) return err;
  pass_kernel<<<l.grid, l.block, l.smem, (cudaStream_t)stream>>>(
      x, tw, rows, (int)log_n, (int)first_stage - 1, (int)stages,
      (int)log_cols);
  return (int)cudaGetLastError();
}

const char* zkm_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
