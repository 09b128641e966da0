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
// memory is cheap, so the query's LUT [M, ksub] f32 sits in shared memory
// and each lookup is one shared load.
//
// What bounds it: the codes read (MB * SEG bytes per slot, 16 KiB at MB
// 64, SEG 256) over 3.35 TB/s, and nearly as much the shared-memory pipe:
// per slot, 256 rows x 128 lookups are 1,024 warp-wide shared loads, and
// the codes take 128 wavefronts to read and 128 to write by the copies; at
// one wavefront per clock per SM, ~0.25-0.28 ms for 51,642 slots on 132
// SMs.
//
// Design:
//   - staging (adc_stage.cuh): persistent blocks walk contiguous slot
//     ranges; each consumer warp bulk-copies its slots' tiles, in chunks
//     of about 4 KiB (a run of byte-rows j), into its own ring of D
//     shared-memory stages, D - 1 chunks ahead of its reads, and a
//     producer warp loads the query's LUT into one of two buffers when the
//     query changes;
//   - compute (adc_cols.cuh, shared with the transposed raw scan): a
//     consumer warp owns a slot, and each lane R neighbouring rows (R = 8
//     at SEG 256), so byte j of its rows is one R-byte shared load, and
//     its R sums are independent chains. Each sum still adds over m =
//     0..M-1 in order, as the plain PyTorch version does, so the two agree
//     bit for bit; no -use_fast_math;
//   - selection: kp rounds of a warp-wide max (one redux) over sortable
//     u32 keys of the values; the lowest lane holding the max (the lowest
//     row, since a lane's rows are contiguous) pops its lowest such row.
//     O(kp R) per lane, no SEG^2 rank count. The rounds are branch-free and
//     run between the next slot's groups of byte-rows, which hide their
//     latency.
// SEG above 512 (R = 16) takes several passes of 32 R rows; the partial
// sums of a pass wait in a per-warp scratch row in device memory, and
// selection there compares (value, row) as one 64-bit key.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "adc_cols.cuh"
#include "adc_stage.cuh"

namespace {

using adc_cols::accumulate;
using adc_stage::Ring;
constexpr unsigned FULL = 0xFFFFFFFFu;

// u32 keys ordered as the floats (-0.0 must arrive as +0.0: the plain
// version's stable sort takes them as equal)
__device__ __forceinline__ uint32_t sortable(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}
__device__ __forceinline__ float unsortable(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// the largest of N keys, as a tree
template <int N>
__device__ __forceinline__ uint32_t max_of(const uint32_t (&k)[N]) {
  uint32_t t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = k[i];
#pragma unroll
  for (int s = 1; s < N; s <<= 1)
#pragma unroll
    for (int i = 0; i + s < N; i += 2 * s) t[i] = max(t[i], t[i + s]);
  return t[0];
}

// Top-kp of one slot whose sums sit in the lanes' registers (lane holds
// rows r0 .. r0+R-1), one round at a time: a round takes the warp-wide max
// of the lanes' best keys; the lowest lane holding it (the lowest row, as
// a lane's rows are contiguous) pops its lowest row with that key. Popped
// rows and rows past seg key as 0, below -inf. Each round is straight-line
// code with no branch, so the next slot's sums, which call round() between
// their groups of byte-rows, hide its latency.
template <int R>
struct Selector {
  uint32_t key[R] = {};
  uint32_t best = 0;
  int t = 0, kp = 0, r0 = 0;   // rounds done, rounds due; no rounds due at first
  float* ov = nullptr;
  int* oi = nullptr;

  __device__ __forceinline__ void start(const float (&acc)[R], int r0_, int seg, int vc,
                                        int kp_, float* ov_, int* oi_) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = r0_ + i;
      key[i] = r >= seg ? 0u : sortable(r < vc ? acc[i] + 0.0f : -INFINITY);
    }
    best = max_of(key);
    t = 0, kp = kp_, r0 = r0_, ov = ov_, oi = oi_;
  }
  __device__ __forceinline__ void round(int lane) {
    const bool on = t < kp;
    const uint32_t m = __reduce_max_sync(FULL, best);
    const bool win = on && lane == __ffs(__ballot_sync(FULL, best == m)) - 1;
    uint32_t at = 0;   // this lane's rows holding the max; the lowest pops
#pragma unroll
    for (int i = 0; i < R; ++i) at |= (key[i] == m ? 1u : 0u) << i;
    const int hit = __ffs(at) - 1;
#pragma unroll
    for (int i = 0; i < R; ++i) key[i] = win && i == hit ? 0u : key[i];
    best = win ? max_of(key) : best;
    const float v = unsortable(m);
    if (win) {
      ov[t] = v;
      oi[t] = v == -INFINITY ? 0 : r0 + hit;
    }
    t += on;
  }
  __device__ __forceinline__ void drain(int lane) {
    while (t < kp) round(lane);
  }
};

// (value, row) as one key: sortable value above ~row, so a larger key is a
// larger value or, at equal values, a lower row. 0: popped (NaN).
__device__ __forceinline__ unsigned long long key64(const float* sc, int r, int vc) {
  const float v = sc[r];
  if (isnan(v)) return 0ull;
  return ((unsigned long long)sortable(r < vc ? v + 0.0f : -INFINITY) << 32) | (uint32_t)~r;
}

// Top-kp of one slot whose sums sit in the warp's scratch row sc[seg]; lane
// l keeps the best of rows l, l+32, ... and rescans them when it wins.
__device__ __forceinline__ void select_scratch(float* sc, int seg, int vc, int kp, float* ov,
                                               int* oi, int lane) {
  __syncwarp();
  unsigned long long best = 0;
  for (int r = lane; r < seg; r += 32) best = max(best, key64(sc, r, vc));
  for (int t = 0; t < kp; ++t) {
    unsigned long long m = best;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = max(m, __shfl_xor_sync(FULL, m, o));
    if (best == m) {
      const int r = (int)~(uint32_t)m;
      const float v = unsortable((uint32_t)(m >> 32));
      ov[t] = v;
      oi[t] = v == -INFINITY ? 0 : r;
      sc[r] = __int_as_float(0x7FFFFFFF);
      best = 0;
      for (int rr = lane; rr < seg; rr += 32) best = max(best, key64(sc, rr, vc));
    }
  }
  __syncwarp();
}

template <int R, bool PACKED>
__global__ void __launch_bounds__(adc_stage::MAX_THREADS, 1) adc_topk_kernel(
    const uint8_t* __restrict__ codes, const float* __restrict__ luts,
    const int* __restrict__ seg_ids, const int* __restrict__ q_ids,
    const int* __restrict__ valid_cnt, int n_slots, int mb, int seg, int m, int ksub, int kp,
    int W, int D, int jc, int nl, float* __restrict__ scratch, float* __restrict__ out_v,
    int* __restrict__ out_i) {
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
  const bool vec = seg % R == 0;
  float* sc = passes > 1 ? scratch + ((size_t)blockIdx.x * W + warp) * seg : nullptr;
  Selector<R> sel;        // the previous slot's selection, in rounds
  adc_stage::Phases ph;   // 0 chunk waits, 1 LUT waits, 2 sums, 3 selection
  ph.start();
  int k = 0;   // this warp's slots so far
  for (int i = warp; i < n; i += W, ++k) {
    const int s = s0 + i;
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
        accumulate<R, PACKED>(acc, stage, lut, j0, jn, seg, ksub, lane * R, vec, sel, lane);
      } else {
        for (int p = 0; p < passes; ++p) {
          const int r0 = p * 32 * R + lane * R;
          float a[R];
#pragma unroll
          for (int b = 0; b < R; ++b) a[b] = (c > 0 && r0 + b < seg) ? sc[r0 + b] : 0.f;
          accumulate<R, PACKED>(a, stage, lut, j0, jn, seg, ksub, r0, vec, sel, lane);
#pragma unroll
          for (int b = 0; b < R; ++b)
            if (r0 + b < seg) sc[r0 + b] = a[b];
        }
      }
      f.next();
      ph.mark(2);
    }
    f.end_slot(k);
    float* ov = out_v + (size_t)s * kp;
    int* oi = out_i + (size_t)s * kp;
    const int vc = valid_cnt[s];
    sel.drain(lane);   // the rounds the sums left over
    if (passes == 1)
      sel.start(acc, lane * R, seg, vc, kp, ov, oi);
    else
      select_scratch(sc, seg, vc, kp, ov, oi, lane);
    ph.mark(3);
  }
  sel.drain(lane);
  ph.flush(lane);
}

using Kernel = void (*)(const uint8_t*, const float*, const int*, const int*, const int*, int,
                        int, int, int, int, int, int, int, int, int, float*, float*, int*);

template <bool PACKED>
Kernel pick(int rows) {
  switch (rows) {
    case 1: return adc_topk_kernel<1, PACKED>;
    case 2: return adc_topk_kernel<2, PACKED>;
    case 4: return adc_topk_kernel<4, PACKED>;
    case 8: return adc_topk_kernel<8, PACKED>;
    case 16: return adc_topk_kernel<16, PACKED>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// Shared-memory bytes of a launch plan (ops/adc.py checks its own count
// against this one).
long long adc_topk_smem_bytes(int W, int D, int chunk_bytes, int lut_bytes, int nl) {
  return adc_stage::smem_bytes(W, D, chunk_bytes, lut_bytes, nl);
}

// codes [n_segs, mb, seg] u8, luts [Q, m, ksub] f32, seg_ids/q_ids/valid_cnt
// [n_slots] i32 -> out_v [n_slots, kp] f32, out_i [n_slots, kp] i32. The
// plan (ops/adc.py::_adc_plan): rows per lane, W consumer warps, D stages
// per warp, jc byte-rows per chunk, nl LUT buffers, grid blocks; scratch
// [grid * W * seg] f32 where seg > 32 * rows. Returns cudaGetLastError().
int adc_topk_launch(const void* codes, const void* luts, const void* seg_ids,
                    const void* q_ids, const void* valid_cnt, int n_slots, int mb, int seg,
                    int m, int ksub, int packed, int kp, int rows, int W, int D, int jc, int nl,
                    int grid, void* scratch, void* out_v, void* out_i, void* stream) {
  const Kernel k = packed ? pick<true>(rows) : pick<false>(rows);
  if (k == nullptr || W < 1 || W > adc_stage::MAX_WARPS || D < 1 || jc < 1 || nl < 1 ||
      nl > 2)
    return (int)cudaErrorInvalidValue;
  const long long smem = adc_stage::smem_bytes(W, D, jc * seg, 4 * m * ksub, nl);
  cudaError_t e =
      cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (n_slots == 0) return 0;
  k<<<grid, 32 * (W + 1), (size_t)smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), static_cast<const float*>(luts),
      static_cast<const int*>(seg_ids), static_cast<const int*>(q_ids),
      static_cast<const int*>(valid_cnt), n_slots, mb, seg, m, ksub, kp, W, D, jc, nl,
      static_cast<float*>(scratch), static_cast<float*>(out_v), static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

#ifdef ADC_PHASES
// the phase counters summed since the last call, then zeroed
int adc_topk_phases(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, adc_stage::adc_phase_cycles, 64);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[8] = {};
  return (int)cudaMemcpyToSymbol(adc_stage::adc_phase_cycles, zero, 64);
}
#endif

}  // extern "C"
