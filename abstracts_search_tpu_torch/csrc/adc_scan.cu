// Raw IVF-PQ ADC scans for Hopper (sm_90a): per-slot sums, no mask, no
// selection.
//
// Replaces three kernels of abstracts_search_tpu/ops/adc.py:
//   _adc_kernel_t       transposed payload [n_segs, MB, SEG], packed or not
//                       (adc_scan_kernel<true, *>)
//   _adc_kernel_packed4 row-major payload [n_segs, SEG, MB], nibble-packed
//                       (adc_rows_packed_kernel, staged)
//   _adc_kernel         row-major payload [n_segs, SEG, M], one code a byte
//                       (adc_scan_kernel<false, false>)
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
// PQ64x8). Each sum is the sequential f32 sum over m = 0..M-1, the order
// the plain PyTorch version adds in, so the two agree bit for bit.
//
// adc_scan_kernel: one thread per row, codes read straight from device
// memory, the LUT restaged when the query changes (slots are query-major
// on the search path). Transposed, byte j of neighbouring rows is at
// neighbouring addresses, so byte loads coalesce; row-major, a row's MB
// bytes are contiguous, so a thread reads its row in 16-byte loads
// (adc_sum.cuh).
//
// adc_rows_packed_kernel (the legacy search path's scan): the staging ring
// of adc_stage.cuh, a warp per slot. Each chunk of the tile (64 rows of 64
// bytes at PQ128x4) is bulk-copied into the warp's shared-memory stages
// ahead of its reads;
// a lane sums rows lane and lane + 32 of the chunk as two independent
// chains. A row is four 16-byte shared loads; at a 64-byte row stride the
// eight lanes of a quarter-warp would hit two 16-byte bank groups (4-way
// conflicts), so lane l starts at chunk (l & 7) / 2 and rotates, and a
// two-step select puts the chunks back in m order in registers. Output
// writes stay coalesced: lane l writes row l of each 32-row group.
//
// What bounds it: the codes read (MB * SEG bytes per slot, 16 KiB at MB 64,
// SEG 256) and the scores written (4 * SEG bytes per slot), over 3.35 TB/s;
// the M shared-memory lookups per row come close (adc_topk.cu).

#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_stage.cuh"
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

// -- the row-major packed scan (kernel 5), staged -------------------------------------

// Row rr of a chunk, NC 16-byte pieces, loaded from piece rot on and put
// back in order (A[k] = piece k) by log2(NC) conditional rotations.
template <int NC>
__device__ __forceinline__ void load_row(const unsigned char* row, int rot, uint4 (&A)[NC]) {
#pragma unroll
  for (int q = 0; q < NC; ++q)
    A[q] = *reinterpret_cast<const uint4*>(row + 16 * ((q + rot) & (NC - 1)));
#pragma unroll
  for (int sh = 1; sh < NC; sh <<= 1) {
    const bool f = rot & sh;
    uint4 T[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const uint4 a = A[(k - sh + NC) & (NC - 1)], b = A[k];
      T[k] = make_uint4(f ? a.x : b.x, f ? a.y : b.y, f ? a.z : b.z, f ? a.w : b.w);
    }
#pragma unroll
    for (int k = 0; k < NC; ++k) A[k] = T[k];
  }
}

// two rows' sums, interleaved: independent chains, each in m order
template <int NC>
__device__ __forceinline__ void sum_rows(const unsigned char* ra, const unsigned char* rb,
                                         int rot, const float* lut, int mb, float& a,
                                         float& b) {
  a = 0.f, b = 0.f;
  if constexpr (NC > 0) {
    const uint32_t lut_s = (uint32_t)__cvta_generic_to_shared(lut);
    uint4 A[NC], B[NC];
    load_row<NC>(ra, rot, A);
    load_row<NC>(rb, rot, B);
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      const uint32_t wa[4] = {A[k].x, A[k].y, A[k].z, A[k].w};
      const uint32_t wb[4] = {B[k].x, B[k].y, B[k].z, B[k].w};
#pragma unroll
      for (int wi = 0; wi < 4; ++wi) {
        // bytes j = 16 k + 4 wi + bb; odd bytes' tables start 128 bytes on
        const adc_stage::Nibbles na(wa[wi], 0x80008000u, 0xC040C040u);
        const adc_stage::Nibbles nb(wb[wi], 0x80008000u, 0xC040C040u);
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const uint32_t base = lut_s + 128 * (16 * k + 4 * wi + bb);
          a = a + na.lo_entry(base, bb);
          b = b + nb.lo_entry(base, bb);
          a = a + na.hi_entry(base, bb);
          b = b + nb.hi_entry(base, bb);
        }
      }
    }
  } else {   // rows not made of 16-byte pieces: byte loads
    const float* l = lut;
    for (int j = 0; j < mb; ++j, l += 32) {
      a = a + l[ra[j] & 15];
      b = b + l[rb[j] & 15];
      a = a + l[16 + (ra[j] >> 4)];
      b = b + l[16 + (rb[j] >> 4)];
    }
  }
}

// NC = mb / 16 where that is 1, 2, 4 or 8, else 0 (byte loads). sr rows
// per chunk.
template <int NC>
__global__ void __launch_bounds__(adc_stage::MAX_THREADS, 1) adc_rows_packed_kernel(
    const uint8_t* __restrict__ codes, const float* __restrict__ luts,
    const int* __restrict__ seg_ids, const int* __restrict__ q_ids, int n_slots, int mb,
    int seg, int m, int W, int D, int sr, int nl, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int chunk_bytes = sr * mb, lut_bytes = 4 * m * 16;
  const adc_stage::Ring g(smem, W, D, chunk_bytes, lut_bytes, nl);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s0 = (int)((long long)n_slots * blockIdx.x / gridDim.x);
  const int n = (int)((long long)n_slots * (blockIdx.x + 1) / gridDim.x) - s0;
  const int nch = (seg + sr - 1) / sr;
  if (threadIdx.x == 0) g.init();
  __syncthreads();
  if (warp == W) {
    adc_stage::post_luts(g, luts, q_ids, s0, n, lut_bytes, lane);
    return;
  }
  adc_stage::Feed f(g, codes, seg_ids, (size_t)seg * mb, chunk_bytes, nch, warp, lane, s0, n);
  // the lane's first 16-byte piece: the quarter-warp's 8 rows then cover
  // every bank group (row r and r + 1 share a group only in other halves)
  const int rot = NC > 1 ? (((lane & 7) * NC) >> 3) & (NC - 1) : 0;
  adc_stage::Phases ph;   // 0 chunk waits, 1 LUT waits, 2 sums
  ph.start();
  int k = 0;
  for (int i = warp; i < n; i += W, ++k) {
    const int s = s0 + i;
    const float* lut = f.begin_slot(k);
    ph.mark(1);
    for (int c = 0; c < nch; ++c) {
      const unsigned char* stage = f.wait_chunk();
      ph.mark(0);
      const int r0 = c * sr, rn = min(sr, seg - r0);
      float* o = out + (size_t)s * seg + r0;
      for (int rr = lane; rr < rn; rr += 64) {
        const bool two = rr + 32 < rn;
        float a, b;
        sum_rows<NC>(stage + (size_t)rr * mb, stage + (size_t)(two ? rr + 32 : rr) * mb, rot,
                     lut, mb, a, b);
        o[rr] = a;
        if (two) o[rr + 32] = b;
      }
      f.next();
      ph.mark(2);
    }
    f.end_slot(k);
  }
  ph.flush(lane);
}

using RowsKernel = void (*)(const uint8_t*, const float*, const int*, const int*, int, int, int,
                            int, int, int, int, int, float*);

RowsKernel pick_rows(int mb) {
  switch (mb % 16 == 0 ? mb / 16 : 0) {
    case 1: return adc_rows_packed_kernel<1>;
    case 2: return adc_rows_packed_kernel<2>;
    case 4: return adc_rows_packed_kernel<4>;
    case 8: return adc_rows_packed_kernel<8>;
    default: return adc_rows_packed_kernel<0>;
  }
}

}  // namespace

extern "C" {

// codes [n_segs, mb, seg] (transposed = 1) or [n_segs, seg, mb] u8 (one
// code a byte; the row-major packed payload has its own launcher below),
// luts [Q, m, ksub] f32, seg_ids/q_ids [n_slots] i32 -> out [n_slots, seg]
// f32. Returns cudaGetLastError().
int adc_scan_launch(const void* codes, const void* luts, const void* seg_ids,
                    const void* q_ids, int n_slots, int mb, int seg, int m, int ksub,
                    int packed, int transposed, int slots_per_block, void* out,
                    void* stream) {
  if (!transposed && packed) return (int)cudaErrorInvalidValue;
  if (n_slots == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (transposed)
    e = packed ? launch<true, true>(codes, luts, seg_ids, q_ids, n_slots, mb, seg, m, ksub,
                                    slots_per_block, out, st)
               : launch<true, false>(codes, luts, seg_ids, q_ids, n_slots, mb, seg, m, ksub,
                                     slots_per_block, out, st);
  else
    e = launch<false, false>(codes, luts, seg_ids, q_ids, n_slots, mb, seg, m, ksub,
                             slots_per_block, out, st);
  return (int)e;
}

// Shared-memory bytes of a staged launch plan (ops/adc.py checks its own
// count against this one).
long long adc_rows_smem_bytes(int W, int D, int chunk_bytes, int lut_bytes, int nl) {
  return adc_stage::smem_bytes(W, D, chunk_bytes, lut_bytes, nl);
}

// The row-major nibble-packed scan: codes [n_segs, seg, mb] u8, luts [Q,
// m, 16] f32 (mb = m / 2) -> out [n_slots, seg] f32. The plan
// (ops/adc.py::_adc_plan): W consumer warps, D stages per warp, sr rows per
// chunk, nl LUT buffers, grid blocks. Returns cudaGetLastError().
int adc_rows_packed_launch(const void* codes, const void* luts, const void* seg_ids,
                           const void* q_ids, int n_slots, int mb, int seg, int m, int W,
                           int D, int sr, int nl, int grid, void* out, void* stream) {
  if (W < 1 || W > adc_stage::MAX_WARPS || D < 1 || sr < 1 || nl < 1 || nl > 2)
    return (int)cudaErrorInvalidValue;
  const RowsKernel k = pick_rows(mb);
  const long long smem = adc_stage::smem_bytes(W, D, sr * mb, 4 * m * 16, nl);
  cudaError_t e =
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (n_slots == 0) return 0;
  k<<<grid, 32 * (W + 1), (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const float*>(luts),
      static_cast<const int*>(seg_ids), static_cast<const int*>(q_ids), n_slots, mb, seg, m,
      W, D, sr, nl, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

#ifdef ADC_PHASES
// the phase counters summed since the last call, then zeroed
int adc_scan_phases(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, adc_stage::adc_phase_cycles, 64);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(adc_stage::adc_phase_cycles, zero, 64);
}
#endif

}  // extern "C"
