// Goldilocks field arithmetic, p = 2^64 - 2^32 + 1, on u64 lanes.
//
// Device counterpart of zkm_tpu/field/goldilocks.py (`add`, `sub`, `mul`,
// `_reduce128`) and of the port's plain versions in
// zkm_tpu_torch/field/goldilocks.py.  Inputs are canonical (< p) and every
// result is canonical, so kernel and plain versions agree bit for bit.
//
// Cost in 32-bit integer operations (used for the kernels' operation
// bounds; an estimate read off this source, not a disassembly count):
//   add ~ 6, sub ~ 4, mul ~ 26 (64x64->128 product as four 32x32 wide
//   multiplies plus carries ~ 16, reduction ~ 10).
#pragma once
#include <cstdint>

namespace gl {

constexpr uint64_t P = 0xFFFFFFFF00000001ull;
constexpr uint64_t EPS = 0xFFFFFFFFull;  // 2^64 mod p

constexpr int ADD_OPS = 6;
constexpr int SUB_OPS = 4;
constexpr int MUL_OPS = 26;

__device__ __forceinline__ uint64_t canonical(uint64_t s) {
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint64_t add(uint64_t a, uint64_t b) {
  uint64_t s = a + b;
  if (s < a) s += EPS;  // carry: s + 2^64 == s + EPS, and s + EPS < p
  return canonical(s);
}

__device__ __forceinline__ uint64_t sub(uint64_t a, uint64_t b) {
  uint64_t d = a - b;
  if (a < b) d -= EPS;  // borrow: d - 2^64 + p == d - EPS
  return d;
}

// (hi * 2^64 + lo) mod p, using 2^64 == EPS and 2^96 == -1.
__device__ __forceinline__ uint64_t reduce128(uint64_t lo, uint64_t hi) {
  uint64_t hi_hi = hi >> 32;
  uint64_t hi_lo = hi & EPS;
  uint64_t t0 = lo - hi_hi;
  if (lo < hi_hi) t0 -= EPS;
  uint64_t t1 = hi_lo * EPS;
  uint64_t t2 = t0 + t1;
  if (t2 < t0) t2 += EPS;
  return canonical(t2);
}

__device__ __forceinline__ uint64_t mul(uint64_t a, uint64_t b) {
  return reduce128(a * b, __umul64hi(a, b));
}

}  // namespace gl
