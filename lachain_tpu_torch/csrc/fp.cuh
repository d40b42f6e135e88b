// The BLS12-381 base field Fp on the card, shared by g1.cu and g2.cu: its
// constants and the traits of coop.cuh's group field (BlsFp), on which
// every G1 and G2 kernel runs.
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

// The field traits of coop.cuh's group field (every g1.cu and g2.cu
// kernel). 2p < 2^383, so no sum carries out of the group and the
// carry word is never read.
struct BlsFp {
  static constexpr int words = NL;
  static constexpr uint32_t pinv = kPInv;
  static constexpr bool top_carry = false;
  static __device__ __forceinline__ uint32_t p_word(int i) { return kP[i]; }
};

}  // namespace
