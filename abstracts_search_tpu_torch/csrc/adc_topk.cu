// Fused IVF-PQ ADC scan + per-slot top-kp for Hopper (sm_90a).
//
// Replaces abstracts_search_tpu/ops/adc.py::_adc_topk_kernel_t. A slot is
// a pair (query q_ids[i], segment seg_ids[i]) over the transposed payload
// codes[n_segs, MB, SEG] (uint8). Each row's score is
// sum_m LUT[q, m, code_m]: nibble-packed payloads (ksub 16, MB = M/2) hold
// subspace 2j in the low nibble of byte j and 2j+1 in the high nibble;
// unpacked ones (ksub up to 256, MB = M) one code per byte. Rows at or past
// valid_cnt[i] are -inf; the slot emits its top-kp (value desc, row asc),
// with (-inf, 0) where fewer than kp rows are valid.
//
// Why the TPU design does not carry over: the TPU avoided gathers with a
// one-hot loop over the ksub code values. On Hopper a gather from shared
// memory is cheap, so the query's LUT [M, ksub] f32 is staged in shared
// memory (8 KiB at PQ128x4; restaged only when the query changes, since
// slots are query-major) and each thread owns one row: for a fixed byte j
// neighbouring rows are neighbouring addresses, so the code reads
// coalesce. A packed lookup touches 16 consecutive words, so it is free
// of bank conflicts. Each score is the sequential f32 sum over m = 0..M-1,
// the same order the plain PyTorch version adds in, so the two agree bit
// for bit (adc_sum.cuh, shared with adc_scan.cu). Selection is one pass:
// every row counts the rows that beat it and, if that rank is below kp,
// writes itself to slot[rank].
//
// What bounds it: the codes read, MB * SEG bytes per slot (16 KiB at
// MB 64, SEG 256), over 3.35 TB/s.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "adc_sum.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) adc_topk_kernel(
    const uint8_t* __restrict__ codes, const float* __restrict__ luts,
    const int* __restrict__ seg_ids, const int* __restrict__ q_ids,
    const int* __restrict__ valid_cnt, int n_slots, int mb, int seg, int m, int ksub,
    int packed, int kp, int slots_per_block, float* __restrict__ out_v,
    int* __restrict__ out_i) {
  extern __shared__ float sm[];
  float* lut = sm;              // [m * ksub]
  float* sc = lut + m * ksub;   // [seg]
  const int t = threadIdx.x;
  const int s_begin = blockIdx.x * slots_per_block;
  const int s_end = min(n_slots, s_begin + slots_per_block);
  int cur_q = -1;
  for (int s = s_begin; s < s_end; ++s) {
    const int qid = q_ids[s];
    __syncthreads();  // the previous slot's readers of lut/sc are done
    if (qid != cur_q) {
      const float* src = luts + (size_t)qid * m * ksub;
      for (int e = t; e < m * ksub; e += THREADS) lut[e] = src[e];
      cur_q = qid;
      __syncthreads();
    }
    const uint8_t* tile = codes + (size_t)seg_ids[s] * mb * seg;
    const int vc = valid_cnt[s];
    for (int r = t; r < seg; r += THREADS) {
      const float acc = packed ? adc_sum_transposed<true>(tile, lut, r, mb, seg, ksub)
                               : adc_sum_transposed<false>(tile, lut, r, mb, seg, ksub);
      sc[r] = r < vc ? acc : -INFINITY;
    }
    __syncthreads();
    // rank selection under (value desc, row asc): ranks are a permutation
    // of 0..seg-1, so exactly kp rows write
    for (int r = t; r < seg; r += THREADS) {
      const float v = sc[r];
      int rank = 0;
      for (int o = 0; o < seg && rank < kp; ++o) {
        const float w = sc[o];
        rank += (w > v) || (w == v && o < r);
      }
      if (rank < kp) {
        out_v[(size_t)s * kp + rank] = v;
        out_i[(size_t)s * kp + rank] = v == -INFINITY ? 0 : r;
      }
    }
  }
}

}  // namespace

extern "C" {

// codes [n_segs, mb, seg] u8, luts [Q, m, ksub] f32, seg_ids/q_ids/valid_cnt
// [n_slots] i32 -> out_v [n_slots, kp] f32, out_i [n_slots, kp] i32.
// Returns cudaGetLastError().
int adc_topk_launch(const void* codes, const void* luts, const void* seg_ids,
                    const void* q_ids, const void* valid_cnt, int n_slots, int mb,
                    int seg, int m, int ksub, int packed, int kp, int slots_per_block,
                    void* out_v, void* out_i, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)m * ksub + seg);
  cudaError_t e = cudaFuncSetAttribute(
      adc_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (n_slots == 0) return 0;
  const int grid = (n_slots + slots_per_block - 1) / slots_per_block;
  adc_topk_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const float*>(luts),
      static_cast<const int*>(seg_ids), static_cast<const int*>(q_ids),
      static_cast<const int*>(valid_cnt), n_slots, mb, seg, m, ksub, packed, kp,
      slots_per_block, static_cast<float*>(out_v), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // extern "C"
