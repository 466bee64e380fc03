// The 3xTF32 arithmetic of the port's tensor-core kernels (K3-K5 in
// flash_attention.cu, K6 in conv_bwd.cu): warp-level mma.sync.m16n8k8
// TF32 products at float32 accuracy.  An operand x is split into two
// TF32 values, big + small, and a product is small*big + big*small +
// big*big, three MMAs with float32 sums.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace mxtpu_port {

// x = big + small to float32 accuracy, both TF32 (10 mantissa bits) as
// cvt.rna.tf32.f32 rounds, to nearest with ties away from zero: half a
// TF32 unit (bit 12) is added to the magnitude and the 13 low bits are
// dropped.  big drops them here, since x - big needs its value; small
// keeps them and the MMA, which reads a TF32 operand's top 19 bits
// only, drops them.  Three integer ops and one float op against the ~8
// of two cvt.rna (ptxas guards each against inf and NaN, which the
// inputs and p = exp(s - m) never hold).
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// d += a.b, one m16n8k8 TF32 product with float32 sums.  Lane (g, t)
// holds a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]; b = B[t][g],
// B[t+4][g]; d = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a.b, the product of mma() into a zero accumulator (one zero
// register stands for all four, so d needs no clearing)
__device__ __forceinline__ void mma0(float (&d)[4], const uint32_t (&a)[4],
                                     uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// d += a.b in 3xTF32: a = ab + as, b = (big0, big1, small0, small1)
// from a plane.  AS (BS) false: a's (b's) small part is zero, as it is
// for an operand read from bfloat16 (exactly TF32), and the product
// with it is skipped.
template <bool AS, bool BS>
__device__ __forceinline__ void mma3s(float (&d)[4], const uint32_t (&ab)[4],
                                      const uint32_t (&as)[4], uint4 b) {
  if (AS) mma(d, as, b.x, b.y);
  if (BS) mma(d, ab, b.z, b.w);
  mma(d, ab, b.x, b.y);
}

// the same with a float32 a and b read from T
template <typename T>
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint4 b) {
  mma3s<true, sizeof(T) == 4>(d, ab, as, b);
}

// the A fragment (rows g, g+8; k = t, t+4) from four float32 values
__device__ __forceinline__ void split_a(float a0, float a1, float a2,
                                        float a3, uint32_t (&big)[4],
                                        uint32_t (&small)[4]) {
  split(a0, big[0], small[0]);
  split(a1, big[1], small[1]);
  split(a2, big[2], small[2]);
  split(a3, big[3], small[3]);
}

}  // namespace mxtpu_port
