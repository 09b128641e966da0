// Raw IVF-PQ ADC scans for Hopper (sm_90a): per-slot sums, no mask, no
// selection.
//
// Replaces three kernels of abstracts_search_tpu/ops/adc.py:
//   _adc_kernel_t       transposed payload [n_segs, MB, SEG], packed or not
//                       (adc_cols_kernel)
//   _adc_kernel_packed4 row-major payload [n_segs, SEG, MB], nibble-packed
//                       (adc_rows_kernel<*, true>)
//   _adc_kernel         row-major payload [n_segs, SEG, M], one code a byte
//                       (adc_rows_kernel<*, false>)
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
// Both kernels run on the staging ring of adc_stage.cuh: persistent
// blocks, a warp per slot, each chunk of the slot's tile bulk-copied into
// the warp's own shared-memory stages ahead of its reads, the query's LUT
// staged by a producer warp into one of two buffers, or one where the plan
// says so (transposed from 64 KiB on; row-major where two leave too little
// room for the ring, as for a 128 KiB LUT): a block crossing a query
// boundary then drains first.
//
// adc_cols_kernel (transposed): the fused scan's sums (adc_cols.cuh) with
// no mask and no selection. Chunks are runs of byte-rows; a lane sums R
// neighbouring rows (R = 8 at SEG 256) and writes them as R/4 16-byte
// stores. Where SEG > 32 R the rows take several passes, and a pass's
// partial sums wait in the output row itself.
//
// adc_rows_kernel (row-major): chunks are runs of rows; a lane sums rows
// lane and lane + 32 of the chunk as two independent chains. A row is
// MB/16 16-byte shared loads; at a 64-byte row stride the eight lanes of
// a quarter-warp would hit two 16-byte bank groups (4-way conflicts), so
// lane l starts at piece (l & 7) * NC / 8 and rotates, and conditional
// selects put the pieces back in m order in registers. Rows whose MB is
// not 16, 32, 64 or 128 take byte loads. A packed lookup is byte_perm +
// ld.shared (adc_stage::Nibbles); a byte lookup a byte extract, a
// shift-add onto the subspace's table and ld.shared. Output writes stay
// coalesced: lane l writes row l of each 32-row group.
//
// What bounds them: the codes read (MB * SEG bytes per slot) and the
// scores written (4 * SEG bytes per slot) over 3.35 TB/s, and nearly as
// much the shared-memory pipe at one wavefront per clock per SM: a warp's
// 32 nibble lookups into a 64-byte table take one wavefront, but 32 random
// byte codes into a 1 KiB table collide on ~3.15 wavefronts on average
// (bank = code mod 32), which no layout of one table avoids. So at PQ64x8
// the lookups, not the bytes, set the floor.

#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_cols.cuh"
#include "adc_stage.cuh"

namespace {

using adc_stage::Ring;

// -- the transposed scan (kernel 4) ---------------------------------------------------

// the raw scan runs nothing between its groups of byte-rows
struct NoRounds {
  __device__ __forceinline__ void round(int) const {}
};

// a lane's R sums of rows r0 .. r0 + R - 1 from / into the output row o:
// 16-byte accesses where the lane's rows are whole and o 16-byte aligned
// (vec4: SEG % 4 == 0)
template <int R>
__device__ __forceinline__ void load_sums(const float* o, int r0, int seg, bool vec4,
                                          float (&a)[R]) {
  if constexpr (R % 4 == 0) {
    if (vec4 && r0 + R <= seg) {
#pragma unroll
      for (int q = 0; q < R / 4; ++q) {
        const float4 v = reinterpret_cast<const float4*>(o + r0)[q];
        a[4 * q] = v.x, a[4 * q + 1] = v.y, a[4 * q + 2] = v.z, a[4 * q + 3] = v.w;
      }
      return;
    }
  }
#pragma unroll
  for (int b = 0; b < R; ++b) a[b] = r0 + b < seg ? o[r0 + b] : 0.f;
}
template <int R>
__device__ __forceinline__ void store_sums(float* o, int r0, int seg, bool vec4,
                                           const float (&a)[R]) {
  if constexpr (R % 4 == 0) {
    if (vec4 && r0 + R <= seg) {
#pragma unroll
      for (int q = 0; q < R / 4; ++q)
        reinterpret_cast<float4*>(o + r0)[q] =
            make_float4(a[4 * q], a[4 * q + 1], a[4 * q + 2], a[4 * q + 3]);
      return;
    }
  }
#pragma unroll
  for (int b = 0; b < R; ++b)
    if (r0 + b < seg) o[r0 + b] = a[b];
}

template <int R, bool PACKED>
__global__ void __launch_bounds__(adc_stage::MAX_THREADS, 1) adc_cols_kernel(
    const uint8_t* __restrict__ codes, const float* __restrict__ luts,
    const int* __restrict__ seg_ids, const int* __restrict__ q_ids, int n_slots, int mb,
    int seg, int m, int ksub, int W, int D, int jc, int nl, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int chunk_bytes = jc * seg, lut_bytes = 4 * m * ksub;
  const Ring g(smem, W, D, chunk_bytes, lut_bytes, nl);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s0 = (int)((long long)n_slots * blockIdx.x / gridDim.x);
  const int n = (int)((long long)n_slots * (blockIdx.x + 1) / gridDim.x) - s0;
  const int nch = (mb + jc - 1) / jc;
  if (threadIdx.x == 0) g.init();
  __syncthreads();
  if (warp == W) {
    adc_stage::post_luts(g, luts, q_ids, s0, n, lut_bytes, lane);
    return;
  }
  adc_stage::Feed f(g, codes, seg_ids, (size_t)mb * seg, chunk_bytes, nch, warp, lane, s0, n);
  const int passes = (seg + 32 * R - 1) / (32 * R);
  const bool vec = seg % R == 0, vec4 = seg % 4 == 0;
  NoRounds none;
  adc_stage::Phases ph;   // 0 chunk waits, 1 LUT waits, 2 sums, 3 stores
  ph.start();
  int k = 0;
  for (int i = warp; i < n; i += W, ++k) {
    float* o = out + (size_t)(s0 + i) * seg;
    float acc[R];
#pragma unroll
    for (int b = 0; b < R; ++b) acc[b] = 0.f;
    const float* lut = f.begin_slot(k);
    ph.mark(1);
    for (int c = 0; c < nch; ++c) {
      const unsigned char* stage = f.wait_chunk();
      ph.mark(0);
      const int j0 = c * jc, jn = min(jc, mb - j0);
      if (passes == 1) {
        adc_cols::accumulate<R, PACKED>(acc, stage, lut, j0, jn, seg, ksub, lane * R, vec,
                                        none, lane);
      } else {   // each pass's partial sums wait in the output row
        for (int p = 0; p < passes; ++p) {
          const int r0 = p * 32 * R + lane * R;
          float a[R];
          if (c > 0) {
            load_sums<R>(o, r0, seg, vec4, a);
          } else {
#pragma unroll
            for (int b = 0; b < R; ++b) a[b] = 0.f;
          }
          adc_cols::accumulate<R, PACKED>(a, stage, lut, j0, jn, seg, ksub, r0, vec, none,
                                          lane);
          store_sums<R>(o, r0, seg, vec4, a);
        }
      }
      f.next();
      ph.mark(2);
    }
    f.end_slot(k);
    if (passes == 1) store_sums<R>(o, lane * R, seg, vec4, acc);
    ph.mark(3);
  }
  ph.flush(lane);
}

using ColsKernel = void (*)(const uint8_t*, const float*, const int*, const int*, int, int, int,
                            int, int, int, int, int, int, float*);

template <bool PACKED>
ColsKernel pick_cols(int rows) {
  switch (rows) {
    case 1: return adc_cols_kernel<1, PACKED>;
    case 2: return adc_cols_kernel<2, PACKED>;
    case 4: return adc_cols_kernel<4, PACKED>;
    case 8: return adc_cols_kernel<8, PACKED>;
    case 16: return adc_cols_kernel<16, PACKED>;
    default: return nullptr;
  }
}

// -- the row-major scans (kernels 5 and 6) --------------------------------------------

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

// two rows' sums, interleaved: independent chains, each in m order.
// PACKED: nibbles (ksub 16); else a code a byte into tables of ksub
// entries
template <int NC, bool PACKED>
__device__ __forceinline__ void sum_rows(const unsigned char* ra, const unsigned char* rb,
                                         int rot, const float* lut, int mb, int ksub, float& a,
                                         float& b) {
  a = 0.f, b = 0.f;
  const uint32_t tb = 4 * ksub;   // bytes per subspace's table
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
        if constexpr (PACKED) {
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
        } else {
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            // byte j = 16 k + 4 wi + bb: subspace j's table, then the entry
            const uint32_t base = lut_s + tb * (16 * k + 4 * wi + bb);
            a = a + adc_stage::lds(base + 4 * __byte_perm(wa[wi], 0, 0x4440 + bb));
            b = b + adc_stage::lds(base + 4 * __byte_perm(wb[wi], 0, 0x4440 + bb));
          }
        }
      }
    }
  } else if constexpr (PACKED) {   // rows not made of 16-byte pieces: byte loads
    const float* l = lut;
    for (int j = 0; j < mb; ++j, l += 32) {
      a = a + l[ra[j] & 15];
      b = b + l[rb[j] & 15];
      a = a + l[16 + (ra[j] >> 4)];
      b = b + l[16 + (rb[j] >> 4)];
    }
  } else {
    const float* l = lut;
    for (int j = 0; j < mb; ++j, l += tb / 4) {
      a = a + l[ra[j]];
      b = b + l[rb[j]];
    }
  }
}

// NC = mb / 16 where that is 1, 2, 4 or 8, else 0 (byte loads). sr rows
// per chunk.
template <int NC, bool PACKED>
__global__ void __launch_bounds__(adc_stage::MAX_THREADS, 1) adc_rows_kernel(
    const uint8_t* __restrict__ codes, const float* __restrict__ luts,
    const int* __restrict__ seg_ids, const int* __restrict__ q_ids, int n_slots, int mb,
    int seg, int m, int ksub, int W, int D, int sr, int nl, float* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int chunk_bytes = sr * mb, lut_bytes = 4 * m * ksub;
  const Ring g(smem, W, D, chunk_bytes, lut_bytes, nl);
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
        sum_rows<NC, PACKED>(stage + (size_t)rr * mb, stage + (size_t)(two ? rr + 32 : rr) * mb,
                             rot, lut, mb, ksub, a, b);
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
                            int, int, int, int, int, int, float*);

template <bool PACKED>
RowsKernel pick_rows(int mb) {
  switch (mb % 16 == 0 ? mb / 16 : 0) {
    case 1: return adc_rows_kernel<1, PACKED>;
    case 2: return adc_rows_kernel<2, PACKED>;
    case 4: return adc_rows_kernel<4, PACKED>;
    case 8: return adc_rows_kernel<8, PACKED>;
    default: return adc_rows_kernel<0, PACKED>;
  }
}

bool bad_plan(int W, int D, int chunk, int nl) {
  return W < 1 || W > adc_stage::MAX_WARPS || D < 1 || chunk < 1 || nl < 1 || nl > 2;
}

// set the kernel's shared memory and launch it with (grid, W + 1 warps)
template <typename Kernel, typename... Args>
int launch(Kernel k, int grid, int W, long long smem, void* stream, Args... args) {
  cudaError_t e =
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k<<<grid, 32 * (W + 1), (size_t)smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared-memory bytes of a launch plan (ops/adc.py checks its own count
// against this one).
long long adc_scan_smem_bytes(int W, int D, int chunk_bytes, int lut_bytes, int nl) {
  return adc_stage::smem_bytes(W, D, chunk_bytes, lut_bytes, nl);
}

// The plans (ops/adc.py::_adc_plan): W consumer warps, D stages per warp,
// a chunk of jc byte-rows (transposed) or sr rows (row-major), nl LUT
// buffers, grid blocks. luts [Q, m, ksub] f32, seg_ids/q_ids [n_slots] i32
// -> out [n_slots, seg] f32. Each returns cudaGetLastError().

// The transposed scan: codes [n_segs, mb, seg] u8, rows per lane a power
// of two up to 16.
int adc_cols_launch(const void* codes, const void* luts, const void* seg_ids,
                    const void* q_ids, int n_slots, int mb, int seg, int m, int ksub,
                    int packed, int rows, int W, int D, int jc, int nl, int grid, void* out,
                    void* stream) {
  const ColsKernel k = packed ? pick_cols<true>(rows) : pick_cols<false>(rows);
  if (k == nullptr || bad_plan(W, D, jc, nl) || (packed && ksub != 16))
    return (int)cudaErrorInvalidValue;
  if (n_slots == 0) return 0;
  return launch(k, grid, W, adc_stage::smem_bytes(W, D, jc * seg, 4 * m * ksub, nl), stream,
                static_cast<const uint8_t*>(codes), static_cast<const float*>(luts),
                static_cast<const int*>(seg_ids), static_cast<const int*>(q_ids), n_slots, mb,
                seg, m, ksub, W, D, jc, nl, static_cast<float*>(out));
}

// The row-major scans: codes [n_segs, seg, mb] u8, nibble-packed (ksub 16,
// mb = m / 2) or a code a byte (mb = m).
int adc_rows_launch(const void* codes, const void* luts, const void* seg_ids,
                    const void* q_ids, int n_slots, int mb, int seg, int m, int ksub,
                    int packed, int W, int D, int sr, int nl, int grid, void* out,
                    void* stream) {
  if (bad_plan(W, D, sr, nl) || (packed && ksub != 16)) return (int)cudaErrorInvalidValue;
  const RowsKernel k = packed ? pick_rows<true>(mb) : pick_rows<false>(mb);
  if (n_slots == 0) return 0;
  return launch(k, grid, W, adc_stage::smem_bytes(W, D, sr * mb, 4 * m * ksub, nl), stream,
                static_cast<const uint8_t*>(codes), static_cast<const float*>(luts),
                static_cast<const int*>(seg_ids), static_cast<const int*>(q_ids), n_slots, mb,
                seg, m, ksub, W, D, sr, nl, static_cast<float*>(out));
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
