// The sums over a transposed [MB, SEG] tile staged by the ring of
// adc_stage.cuh, shared by the fused scan + top-k (adc_topk.cu, kernel 3)
// and the transposed raw scan (adc_scan.cu, kernel 4).
//
// A consumer warp owns a slot, and each lane R neighbouring rows
// r0 .. r0 + R - 1, so byte j of its rows is one R-byte shared load, and
// its R sums are independent chains. Each sum adds over m = 0..M-1 in
// order, as the plain PyTorch version does, so the two agree bit for bit.
// Nibble-packed payloads (ksub 16, MB = M/2) hold subspace 2j in the low
// nibble of byte j and 2j+1 in the high nibble; unpacked ones (ksub up to
// 256, MB = M) one code per byte.
//
// accumulate_rows calls hook.round(lane) once per group of four
// byte-rows: the fused scan runs a round of the previous slot's selection
// there, the raw scan nothing.

#pragma once

#include <stdint.h>

#include "adc_stage.cuh"

namespace adc_cols {

// byte j of rows [r0, r0 + R) from one byte-row p of the stage, packed
// into words. VEC (seg % R == 0): one R-byte load, p R-aligned; a lane
// whose rows start past seg (live false) loads a valid address and keeps
// zeros, so the loads need no branch and can be hoisted. Else byte loads.
template <int R, bool VEC>
__device__ __forceinline__ void load_codes(const unsigned char* p, bool live, int r0, int seg,
                                           uint32_t (&w)[(R + 3) / 4]) {
  if constexpr (VEC) {
    if constexpr (R == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
    } else if constexpr (R == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x, w[1] = v.y;
    } else if constexpr (R == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else if constexpr (R == 2) {
      w[0] = *reinterpret_cast<const uint16_t*>(p);
    } else {
      w[0] = *p;
    }
#pragma unroll
    for (int q = 0; q < (R + 3) / 4; ++q) w[q] = live ? w[q] : 0u;
  } else {
#pragma unroll
    for (int q = 0; q < (R + 3) / 4; ++q) w[q] = 0;
#pragma unroll
    for (int b = 0; b < R; ++b)
      if (r0 + b < seg) w[b >> 2] |= (uint32_t)p[b] << (8 * (b & 3));
  }
}

// acc[b] += the lookups of byte-row j for row r0 + b (code words w), in m
// order. Packed: each lookup is a byte_perm and a shared load
// (adc_stage::Nibbles).
template <int R, bool PACKED>
__device__ __forceinline__ void add_codes(float (&acc)[R], const uint32_t (&w)[(R + 3) / 4],
                                          int j, uint32_t lut_s, const float* lut, int ksub) {
  if (PACKED) {
    // subspaces 2j, 2j + 1: 16 floats each, at lut + 128 j and + 64
    const uint32_t base = lut_s + 128 * j;
#pragma unroll
    for (int q = 0; q < (R + 3) / 4; ++q) {
      const adc_stage::Nibbles nb(w[q], (j & 1) ? 0x80808080u : 0u,
                                  (j & 1) ? 0xC0C0C0C0u : 0x40404040u);
#pragma unroll
      for (int bb = 0; bb < (R < 4 ? R : 4); ++bb) {
        const int b = 4 * q + bb;
        acc[b] = acc[b] + nb.lo_entry(base, bb);
        acc[b] = acc[b] + nb.hi_entry(base, bb);
      }
    }
  } else {
    const float* lj = lut + (size_t)j * ksub;
#pragma unroll
    for (int q = 0; q < (R + 3) / 4; ++q)
#pragma unroll
      for (int bb = 0; bb < (R < 4 ? R : 4); ++bb) {
        const int b = 4 * q + bb;
        acc[b] = acc[b] + lj[__byte_perm(w[q], 0, 0x4440 + bb)];
      }
  }
}

// acc[b] += the lookups of byte-rows j0 .. j0+jn-1 for row r0 + b, in m
// order; the code words of four byte-rows are loaded before their lookups,
// and each group of four also calls hook.round(lane).
template <int R, bool PACKED, bool VEC, class Hook>
__device__ __forceinline__ void accumulate_rows(float (&acc)[R], const unsigned char* stage,
                                                const float* lut, int j0, int jn, int seg,
                                                int ksub, int r0, Hook& hook, int lane) {
  const bool live = r0 < seg;
  const unsigned char* col = stage + (live ? r0 : 0);
  const uint32_t lut_s = (uint32_t)__cvta_generic_to_shared(lut);
  int jj = 0;
  for (; jj + 4 <= jn; jj += 4) {
    uint32_t w[4][(R + 3) / 4];
#pragma unroll
    for (int g = 0; g < 4; ++g)
      load_codes<R, VEC>(col + (size_t)(jj + g) * seg, live, r0, seg, w[g]);
    hook.round(lane);
#pragma unroll
    for (int g = 0; g < 4; ++g) add_codes<R, PACKED>(acc, w[g], j0 + jj + g, lut_s, lut, ksub);
  }
  for (; jj < jn; ++jj) {
    uint32_t w[(R + 3) / 4];
    load_codes<R, VEC>(col + (size_t)jj * seg, live, r0, seg, w);
    add_codes<R, PACKED>(acc, w, j0 + jj, lut_s, lut, ksub);
  }
}

// a sum's chunk: the vector or the byte loads
template <int R, bool PACKED, class Hook>
__device__ __forceinline__ void accumulate(float (&acc)[R], const unsigned char* stage,
                                           const float* lut, int j0, int jn, int seg, int ksub,
                                           int r0, bool vec, Hook& hook, int lane) {
  if (vec)
    accumulate_rows<R, PACKED, true>(acc, stage, lut, j0, jn, seg, ksub, r0, hook, lane);
  else
    accumulate_rows<R, PACKED, false>(acc, stage, lut, j0, jn, seg, ksub, r0, hook, lane);
}

}  // namespace adc_cols
