// One row's ADC sum for the unstaged scans of adc_scan.cu (kernels 4 and
// 6); the staged kernels (adc_topk.cu, the row-major packed scan) add in
// the same order from shared memory (adc_stage.cuh).
//
// lut is the query's [m, ksub] f32 table in shared memory. Packed
// payloads (ksub 16, mb = m/2 bytes) hold subspace 2j in the low nibble of
// byte j and 2j+1 in the high nibble; unpacked ones (mb = m) one code per
// byte. The sum is the sequential f32 sum over m = 0..M-1, the order the
// plain PyTorch versions add in, so kernels and plain versions agree bit
// for bit.

#pragma once

#include <stdint.h>

template <bool PACKED>
__device__ __forceinline__ float adc_add_byte(float acc, const float* lut, int j, int ksub,
                                              unsigned c) {
  if (PACKED) {
    acc = acc + lut[(2 * j) * 16 + (c & 15u)];
    return acc + lut[(2 * j + 1) * 16 + (c >> 4)];
  }
  return acc + lut[j * ksub + c];
}

// Row r of a transposed [mb, seg] block: byte j of neighbouring rows sits
// at neighbouring addresses, so a warp's byte loads coalesce.
template <bool PACKED>
__device__ __forceinline__ float adc_sum_transposed(const uint8_t* __restrict__ tile,
                                                    const float* lut, int r, int mb,
                                                    int seg, int ksub) {
  float acc = 0.f;
  int j = 0;
  for (; j + 8 <= mb; j += 8) {
    unsigned c[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) c[u] = tile[(size_t)(j + u) * seg + r];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc = adc_add_byte<PACKED>(acc, lut, j + u, ksub, c[u]);
  }
  for (; j < mb; ++j) acc = adc_add_byte<PACKED>(acc, lut, j, ksub, tile[(size_t)j * seg + r]);
  return acc;
}

// A row-major row's mb contiguous bytes: 16-byte loads where rows are
// 16-byte aligned (mb a multiple of 16).
template <bool PACKED>
__device__ __forceinline__ float adc_sum_row(const uint8_t* __restrict__ row,
                                             const float* lut, int mb, int ksub) {
  float acc = 0.f;
  int j = 0;
  if ((mb & 15) == 0) {
    for (; j < mb; j += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(row + j);
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int b = 0; b < 16; ++b)
        acc = adc_add_byte<PACKED>(acc, lut, j + b, ksub, (w[b >> 2] >> (8 * (b & 3))) & 255u);
    }
  }
  for (; j < mb; ++j) acc = adc_add_byte<PACKED>(acc, lut, j, ksub, row[j]);
  return acc;
}
