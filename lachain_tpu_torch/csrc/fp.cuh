// The BLS12-381 base field Fp on the card, shared by g1.cu and g2.cu: its
// constants, the traits of coop.cuh's group field (BlsFp), on which every
// G1 and G2 kernel but fp_mul runs, and the one-thread field of g1.cu's
// fp_mul_kernel (Fp, mont_mul), which stays until that kernel moves to the
// group field.
//
// A field element is 12 x 32-bit limbs in Montgomery form (R = 2^384),
// always canonical in [0, p). Arrays are lane-minor: limb i of lane l sits
// at row i, column l, so a warp's loads of one limb coalesce.
//
// Everything here has internal linkage (anonymous namespace): each .cu file
// that includes it gets its own copy, so the translation units never collide
// when they are linked into one library.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int NL = 12;  // 32-bit limbs per Fp element

__constant__ uint32_t kP[NL] = {
    0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu,
    0xf6b0f624u, 0x6730d2a0u, 0xf38512bfu, 0x64774b84u,
    0x434bacd7u, 0x4b1ba7b6u, 0x397fe69au, 0x1a0111eau};
constexpr uint32_t kPInv = 0xfffcfffdu;  // -p^-1 mod 2^32
// R^2 mod p, R = 2^384: a product by it converts into Montgomery form
__constant__ uint32_t kR2[NL] = {
    0x1c341746u, 0xf4df1f34u, 0x09d104f1u, 0x0a76e6a6u,
    0x4c95b6d5u, 0x8de5476cu, 0x939d83c0u, 0x67eb88a9u,
    0xb519952du, 0x9a793e85u, 0x92cae3aau, 0x11988fe5u};

// The field traits of coop.cuh's group field (g1.cu's and g2.cu's kernels
// but fp_mul). 2p < 2^383, so no sum carries out of the group and the
// carry word is never read.
struct BlsFp {
  static constexpr int words = NL;
  static constexpr uint32_t pinv = kPInv;
  static constexpr bool top_carry = false;
  static __device__ __forceinline__ uint32_t p_word(int i) { return kP[i]; }
};

struct Fp {
  uint32_t v[NL];
};

// a - p when a >= p; requires a < 2p.
__device__ __forceinline__ Fp reduce_once(const Fp& a) {
  Fp t;
  uint32_t borrow = 0u;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const uint64_t d = (uint64_t)a.v[i] - kP[i] - borrow;
    t.v[i] = (uint32_t)d;
    borrow = (uint32_t)(d >> 63);
  }
  Fp r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = borrow ? a.v[i] : t.v[i];
  return r;
}

// CIOS Montgomery product a*b/R mod p for a, b < p; the result is < 2p
// before the final subtraction since 4p < R.
__device__ __forceinline__ Fp mont_mul(const Fp& a, const Fp& b) {
  uint32_t t[NL + 2];
#pragma unroll
  for (int i = 0; i < NL + 2; ++i) t[i] = 0u;
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NL; ++j) {
      c += (uint64_t)a.v[j] * b.v[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NL];
    t[NL] = (uint32_t)c;
    t[NL + 1] = (uint32_t)(c >> 32);
    const uint32_t m = t[0] * kPInv;
    c = ((uint64_t)m * kP[0] + t[0]) >> 32;
#pragma unroll
    for (int j = 1; j < NL; ++j) {
      c += (uint64_t)m * kP[j] + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[NL];
    t[NL - 1] = (uint32_t)c;
    t[NL] = t[NL + 1] + (uint32_t)(c >> 32);
  }
  Fp r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = t[i];
  return reduce_once(r);
}

__device__ __forceinline__ Fp load_fp(const uint32_t* __restrict__ a,
                                      int row0, int n, int lane) {
  Fp r;
#pragma unroll
  for (int i = 0; i < NL; ++i) r.v[i] = a[(size_t)(row0 + i) * n + lane];
  return r;
}

__device__ __forceinline__ void store_fp(uint32_t* __restrict__ a, int row0,
                                         int n, int lane, const Fp& v) {
#pragma unroll
  for (int i = 0; i < NL; ++i) a[(size_t)(row0 + i) * n + lane] = v.v[i];
}

}  // namespace
