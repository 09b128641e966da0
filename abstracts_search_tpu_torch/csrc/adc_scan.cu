// Raw IVF-PQ ADC scans for Hopper (sm_90a): per-slot sums, no mask, no
// selection.
//
// Replaces three kernels of abstracts_search_tpu/ops/adc.py, one template
// instance each:
//   _adc_kernel_t       transposed payload [n_segs, MB, SEG], packed or not
//   _adc_kernel_packed4 row-major payload [n_segs, SEG, MB], nibble-packed
//   _adc_kernel         row-major payload [n_segs, SEG, M], one code a byte
// A slot is a pair (query q_ids[i], segment seg_ids[i]); the output row i
// holds, for each row r of the segment, sum_m LUT[q, m, code_m(r)]. Packed
// payloads (ksub 16, MB = M/2) hold subspace 2j in the low nibble of byte
// j and 2j+1 in the high nibble; unpacked ones (ksub up to 256, MB = M)
// one code per byte.
//
// Why the TPU design does not carry over: the TPU avoided gathers with a
// one-hot compare against the LUT (and, row-major, a lane repeat of the
// codes). On Hopper a gather from shared memory is cheap, so the query's
// LUT [M, ksub] f32 sits in shared memory (8 KiB at PQ128x4, 64 KiB at
// PQ64x8; restaged only when the query changes, since slots are
// query-major) and each thread owns one row. Transposed, byte j of
// neighbouring rows is at neighbouring addresses, so byte loads coalesce;
// row-major, a row's MB bytes are contiguous, so a thread reads its row in
// 16-byte loads. Each sum is the sequential f32 sum over m = 0..M-1, the
// order the plain PyTorch version adds in, so the two agree bit for bit
// (adc_sum.cuh, shared with adc_topk.cu).
//
// What bounds it: the codes read (MB * SEG bytes per slot, 16 KiB at MB 64,
// SEG 256) and the scores written (4 * SEG bytes per slot), over 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_sum.cuh"

namespace {

constexpr int THREADS = 256;

template <bool TRANSPOSED, bool PACKED>
__global__ void __launch_bounds__(THREADS) adc_scan_kernel(
    const uint8_t* __restrict__ codes, const float* __restrict__ luts,
    const int* __restrict__ seg_ids, const int* __restrict__ q_ids, int n_slots, int mb,
    int seg, int m, int ksub, int slots_per_block, float* __restrict__ out) {
  extern __shared__ float lut[];  // [m * ksub]
  const int t = threadIdx.x;
  const int s_begin = blockIdx.x * slots_per_block;
  const int s_end = min(n_slots, s_begin + slots_per_block);
  int cur_q = -1;
  for (int s = s_begin; s < s_end; ++s) {
    const int qid = q_ids[s];
    if (qid != cur_q) {
      __syncthreads();  // the previous query's readers are done
      const float* src = luts + (size_t)qid * m * ksub;
      for (int e = t; e < m * ksub; e += THREADS) lut[e] = src[e];
      cur_q = qid;
      __syncthreads();
    }
    const uint8_t* tile = codes + (size_t)seg_ids[s] * mb * seg;
    for (int r = t; r < seg; r += THREADS) {
      const float acc = TRANSPOSED
                            ? adc_sum_transposed<PACKED>(tile, lut, r, mb, seg, ksub)
                            : adc_sum_row<PACKED>(tile + (size_t)r * mb, lut, mb, ksub);
      out[(size_t)s * seg + r] = acc;
    }
  }
}

template <bool TRANSPOSED, bool PACKED>
cudaError_t launch(const void* codes, const void* luts, const void* seg_ids,
                   const void* q_ids, int n_slots, int mb, int seg, int m, int ksub,
                   int slots_per_block, void* out, cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)m * ksub;
  cudaError_t e = cudaFuncSetAttribute(adc_scan_kernel<TRANSPOSED, PACKED>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  const int grid = (n_slots + slots_per_block - 1) / slots_per_block;
  adc_scan_kernel<TRANSPOSED, PACKED><<<grid, THREADS, smem, st>>>(
      static_cast<const uint8_t*>(codes), static_cast<const float*>(luts),
      static_cast<const int*>(seg_ids), static_cast<const int*>(q_ids), n_slots, mb, seg,
      m, ksub, slots_per_block, static_cast<float*>(out));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// codes [n_segs, mb, seg] (transposed = 1) or [n_segs, seg, mb] u8, luts
// [Q, m, ksub] f32, seg_ids/q_ids [n_slots] i32 -> out [n_slots, seg] f32.
// Returns cudaGetLastError().
int adc_scan_launch(const void* codes, const void* luts, const void* seg_ids,
                    const void* q_ids, int n_slots, int mb, int seg, int m, int ksub,
                    int packed, int transposed, int slots_per_block, void* out,
                    void* stream) {
  if (n_slots == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (transposed)
    e = packed ? launch<true, true>(codes, luts, seg_ids, q_ids, n_slots, mb, seg, m, ksub,
                                    slots_per_block, out, st)
               : launch<true, false>(codes, luts, seg_ids, q_ids, n_slots, mb, seg, m, ksub,
                                     slots_per_block, out, st);
  else
    e = packed ? launch<false, true>(codes, luts, seg_ids, q_ids, n_slots, mb, seg, m, ksub,
                                     slots_per_block, out, st)
               : launch<false, false>(codes, luts, seg_ids, q_ids, n_slots, mb, seg, m,
                                      ksub, slots_per_block, out, st);
  return (int)e;
}

}  // extern "C"
