// Streaming top-k of q . x^T for Hopper (sm_90a), exact and fast mode.
//
// Replaces abstracts_search_tpu/ops/topk.py::_topk_kernel (exact mode,
// with its fold _fold_exact) and ::_topk_kernel_fast (fast mode, keys
// _pack_keys/_unpack_keys). Scores accumulate in f32 (bf16 operands are
// widened; their products are exact in f32) and rows at or past n_valid
// never win.
//   exact: ties go to the lowest row; slots with no candidate come back
//     as (-inf, 0).
//   fast: each chunk of 2^chunk_log2 rows (from row 0) compares scores
//     truncated to their sortable int32 key with the low lane_bits bits
//     cleared (negative scores round toward -inf). Among equal truncated
//     values the earlier chunk wins, then the higher lane. One unique
//     int64 key carries that whole order -- high word the truncated key,
//     low word (n_chunks-1-chunk) << chunk_log2 | lane -- so a plain max
//     reproduces the reference's per-chunk packed top-k followed by its
//     stable merge, and no tie rule is needed. The value decodes from the
//     high word, the row from the low word. The wrapper adds the sentinel
//     rows that fill the tail when fewer than k rows are valid.
//
// Why the TPU design does not carry over: the Pallas grid walks the
// corpus in order on one core with the running top-k in VMEM. Hopper runs
// blocks in no order, so the corpus axis is split instead:
//   pass 1 (topk_range_kernel): block (range r, query tile) scores a QT x
//     TN tile at a time with f32 FMAs from shared memory and folds each
//     tile into a sorted per-query top-k list in shared memory. A row
//     enters only if it beats the list's current k-th entry, so after the
//     first tiles almost nothing is inserted. Each range writes its sorted
//     list to a [Q, ranges, k] scratch.
//   pass 2 (topk_merge_kernel): one block per query merges the sorted
//     range lists head by head (k rounds of a block-wide argmax over the
//     heads) under the same order.
//
// What bounds it: the corpus read (at the probe shape, 65,536 x 1024 bf16
// centroids, 128 MiB, ~40 us at 3.35 TB/s; at flat search's 2,097,152 x
// 1024 bf16, 4.3 GB, ~1.3 ms). Larger Q re-reads the corpus once per query
// tile and moves toward the f32 FMA rate; tensor cores (mma/wgmma) are the
// next step. No --use_fast_math: decoded fast-mode values may be denormal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int DK = 32;                  // depth staged per step
constexpr int IDX_NONE = 0x7fffffff;    // empty list slot (exact mode)
constexpr unsigned FULL = 0xffffffffu;

struct KeyParams {
  int lane_bits;    // fast mode: mantissa bits replaced by the lane
  int chunk_log2;   // fast mode: rows per chunk = 1 << chunk_log2
  int n_chunks;     // fast mode: chunks in the corpus
};

// Exact mode: a (value, row) pair under (value desc, row asc).
struct ExactSel {
  struct E {
    float v;
    int i;
  };
  static __device__ __forceinline__ E none() { return {-INFINITY, IDX_NONE}; }
  static __device__ __forceinline__ E make(float s, int row, const KeyParams&) {
    return {s, row};
  }
  static __device__ __forceinline__ bool better(E a, E b) {
    return a.v > b.v || (a.v == b.v && a.i < b.i);
  }
  static __device__ __forceinline__ bool empty(E a) { return a.v == -INFINITY; }
  static __device__ __forceinline__ E shfl(E a, int src) {
    return {__shfl_sync(FULL, a.v, src), __shfl_sync(FULL, a.i, src)};
  }
  static __device__ __forceinline__ E shfl_xor(E a, int o) {
    return {__shfl_xor_sync(FULL, a.v, o), __shfl_xor_sync(FULL, a.i, o)};
  }
  static __device__ __forceinline__ void out(E a, const KeyParams&, float* v, int* i) {
    *v = empty(a) ? -INFINITY : a.v;
    *i = empty(a) ? 0 : a.i;
  }
};

// Fast mode: one unique int64 key (see the header), larger is better.
struct FastSel {
  using E = long long;
  static __device__ __forceinline__ E none() { return (long long)INT64_MIN; }
  static __device__ __forceinline__ E make(float s, int row, const KeyParams& p) {
    const int si = __float_as_int(s);
    const int key = si ^ ((si >> 31) & 0x7fffffff);   // signed order = float order
    const int hi = key >> p.lane_bits;                 // arithmetic: truncates
    const unsigned chunk = (unsigned)row >> p.chunk_log2;
    const unsigned lane = (unsigned)row & ((1u << p.chunk_log2) - 1u);
    const unsigned lo = (((unsigned)p.n_chunks - 1u - chunk) << p.chunk_log2) | lane;
    return (long long)(((unsigned long long)(long long)hi << 32) | lo);
  }
  static __device__ __forceinline__ bool better(E a, E b) { return a > b; }
  static __device__ __forceinline__ bool empty(E a) { return a == none(); }
  static __device__ __forceinline__ E shfl(E a, int src) { return __shfl_sync(FULL, a, src); }
  static __device__ __forceinline__ E shfl_xor(E a, int o) {
    return __shfl_xor_sync(FULL, a, o);
  }
  static __device__ __forceinline__ void out(E a, const KeyParams& p, float* v, int* i) {
    if (empty(a)) {
      *v = -INFINITY;
      *i = 0;
      return;
    }
    const int kv = (int)((unsigned)(int)(a >> 32) << p.lane_bits);
    *v = __int_as_float(kv ^ ((kv >> 31) & 0x7fffffff));
    const unsigned lo = (unsigned)(unsigned long long)a;
    const unsigned chunk = (unsigned)p.n_chunks - 1u - (lo >> p.chunk_log2);
    *i = (int)((chunk << p.chunk_log2) | (lo & ((1u << p.chunk_log2) - 1u)));
  }
};

static_assert(sizeof(ExactSel::E) == 8 && sizeof(FastSel::E) == 8, "8-byte entries");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int QT, int TN>
struct Tile {
  static constexpr int QPT = QT >= 16 ? QT / 16 : 1;   // queries per thread
  static constexpr int NQG = QT / QPT;                 // query groups
  static constexpr int NRG = THREADS / NQG;            // row groups
  static constexpr int RPT = TN / NRG;                 // rows per thread
  static constexpr int FLOATS = QT * DK + TN * (DK + 1) + QT * TN;
  static_assert(NQG * NRG == THREADS, "thread layout");
  static_assert(RPT * NRG == TN, "row layout");
  static_assert(TN % 32 == 0, "selection layout");
  static_assert(FLOATS % 2 == 0, "list entries start 8-byte aligned");
  static size_t smem(int k) { return sizeof(float) * FLOATS + 8 * (size_t)QT * k; }
};

template <typename Sel, typename T, int QT, int TN>
__global__ void __launch_bounds__(THREADS) topk_range_kernel(
    const T* __restrict__ q, const T* __restrict__ x, int nq, int n_eff, int d,
    int k, int range_rows, KeyParams kp, typename Sel::E* __restrict__ cand) {
  using L = Tile<QT, TN>;
  using E = typename Sel::E;
  constexpr int WARPS = THREADS / 32;

  extern __shared__ float smem[];
  float* qs = smem;                                  // [QT][DK]
  float* xs = qs + QT * DK;                          // [TN][DK + 1]
  float* sc = xs + TN * (DK + 1);                    // [QT][TN]
  E* lst = reinterpret_cast<E*>(smem + L::FLOATS);   // [QT][k] sorted lists

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int tq = t / L::NRG, tr = t % L::NRG;
  const int q0 = blockIdx.y * QT;
  const int r_begin = blockIdx.x * range_rows;
  const int r_end = min(r_begin + range_rows, n_eff);

  for (int e = t; e < QT * k; e += THREADS) lst[e] = Sel::none();

  for (int r0 = r_begin; r0 < r_end; r0 += TN) {
    float acc[L::QPT][L::RPT];
#pragma unroll
    for (int i = 0; i < L::QPT; ++i)
#pragma unroll
      for (int j = 0; j < L::RPT; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += DK) {
      __syncthreads();  // earlier readers of qs/xs/sc are done
      for (int e = t; e < QT * DK; e += THREADS) {
        const int qi = e / DK, gd = d0 + e % DK, gq = q0 + qi;
        qs[e] = (gq < nq && gd < d) ? to_f32(q[(size_t)gq * d + gd]) : 0.f;
      }
      for (int e = t; e < TN * DK; e += THREADS) {
        const int ri = e / DK, dd = e % DK, gr = r0 + ri, gd = d0 + dd;
        xs[ri * (DK + 1) + dd] =
            (gr < r_end && gd < d) ? to_f32(x[(size_t)gr * d + gd]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int dd = 0; dd < DK; ++dd) {
        float a[L::QPT], b[L::RPT];
#pragma unroll
        for (int i = 0; i < L::QPT; ++i) a[i] = qs[(tq * L::QPT + i) * DK + dd];
#pragma unroll
        for (int j = 0; j < L::RPT; ++j) b[j] = xs[(tr + j * L::NRG) * (DK + 1) + dd];
#pragma unroll
        for (int i = 0; i < L::QPT; ++i)
#pragma unroll
          for (int j = 0; j < L::RPT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < L::QPT; ++i)
#pragma unroll
      for (int j = 0; j < L::RPT; ++j) {
        const int ri = tr + j * L::NRG;
        sc[(tq * L::QPT + i) * TN + ri] = (r0 + ri < r_end) ? acc[i][j] : -INFINITY;
      }
    __syncthreads();

    // fold the tile: warp w owns queries w, w + WARPS, ...; rows are
    // visited in ascending order, so an equal later row never displaces
    for (int qi = warp; qi < QT; qi += WARPS) {
      E* v = lst + qi * k;
      for (int s = 0; s < TN / 32; ++s) {
        const int ri = s * 32 + lane;
        const float cv = sc[qi * TN + ri];
        const E ce = cv != -INFINITY ? Sel::make(cv, r0 + ri, kp) : Sel::none();
        const bool want = !Sel::empty(ce) && Sel::better(ce, v[k - 1]);
        unsigned mask = __ballot_sync(FULL, want);
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const E ne = Sel::shfl(ce, src);
          if (!Sel::better(ne, v[k - 1])) continue;  // warp-uniform
          int pos = 0;  // entries better than the candidate (list is sorted)
          for (int p = lane; p < k; p += 32) pos += Sel::better(v[p], ne);
#pragma unroll
          for (int o = 16; o; o >>= 1) pos += __shfl_xor_sync(FULL, pos, o);
          // shift [pos, k-2] right by one, highest block of 32 first
          for (int base = ((k - 1) / 32) * 32; base >= 0; base -= 32) {
            const int p = base + lane;
            const bool act = p > pos && p < k;
            E tv = Sel::none();
            if (act) tv = v[p - 1];
            __syncwarp();
            if (act) v[p] = tv;
            __syncwarp();
          }
          if (lane == 0) v[pos] = ne;
          __syncwarp();
        }
      }
    }
  }
  __syncthreads();
  for (int e = t; e < QT * k; e += THREADS) {
    const int qi = e / k, p = e % k, gq = q0 + qi;
    if (gq < nq) cand[((size_t)gq * gridDim.x + blockIdx.x) * k + p] = lst[e];
  }
}

// One block per query: k rounds of a block-wide argmax over the heads of
// the sorted per-range lists.
template <typename Sel>
__global__ void __launch_bounds__(THREADS) topk_merge_kernel(
    const typename Sel::E* __restrict__ cand, int n_ranges, int k, KeyParams kp,
    float* __restrict__ out_v, int* __restrict__ out_i) {
  using E = typename Sel::E;
  extern __shared__ int ptr[];  // [n_ranges] head of each range list
  __shared__ E we[THREADS / 32];
  __shared__ int wr[THREADS / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t base = (size_t)blockIdx.x * n_ranges * k;
  for (int r = t; r < n_ranges; r += THREADS) ptr[r] = 0;
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    E be = Sel::none();
    int br = -1;
    for (int r = t; r < n_ranges; r += THREADS) {
      const int p = ptr[r];
      if (p < k) {
        const E e = cand[base + (size_t)r * k + p];
        if (Sel::better(e, be)) {
          be = e;
          br = r;
        }
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const E oe = Sel::shfl_xor(be, o);
      const int orr = __shfl_xor_sync(FULL, br, o);
      if (Sel::better(oe, be)) {
        be = oe;
        br = orr;
      }
    }
    if (lane == 0) {
      we[warp] = be;
      wr[warp] = br;
    }
    __syncthreads();
    if (t == 0) {
      for (int w = 1; w < THREADS / 32; ++w)
        if (Sel::better(we[w], be)) {
          be = we[w];
          br = wr[w];
        }
      Sel::out(be, kp, &out_v[(size_t)blockIdx.x * k + j], &out_i[(size_t)blockIdx.x * k + j]);
      if (!Sel::empty(be)) ptr[br] += 1;
    }
    __syncthreads();
  }
}

template <typename Sel, typename T, int QT, int TN>
cudaError_t launch_ranges(const void* q, const void* x, int nq, int n_eff, int d,
                          int k, int n_ranges, int range_rows, KeyParams kp,
                          typename Sel::E* cand, cudaStream_t st) {
  const size_t smem = Tile<QT, TN>::smem(k);
  cudaError_t e = cudaFuncSetAttribute(topk_range_kernel<Sel, T, QT, TN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(n_ranges, (nq + QT - 1) / QT);
  topk_range_kernel<Sel, T, QT, TN><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(x), nq, n_eff, d, k,
      range_rows, kp, cand);
  return cudaGetLastError();
}

template <typename Sel>
int launch(const void* q, const void* x, int is_bf16, int nq, int n_eff, int d, int k,
           int qt, int n_ranges, int range_rows, KeyParams kp, void* cand_p,
           void* out_v, void* out_i, cudaStream_t st) {
  using E = typename Sel::E;
  E* cand = static_cast<E*>(cand_p);
  cudaError_t e;
  if (qt == 32)
    e = is_bf16 ? launch_ranges<Sel, __nv_bfloat16, 32, 64>(q, x, nq, n_eff, d, k, n_ranges,
                                                            range_rows, kp, cand, st)
                : launch_ranges<Sel, float, 32, 64>(q, x, nq, n_eff, d, k, n_ranges,
                                                    range_rows, kp, cand, st);
  else if (qt == 8)
    e = is_bf16 ? launch_ranges<Sel, __nv_bfloat16, 8, 128>(q, x, nq, n_eff, d, k, n_ranges,
                                                            range_rows, kp, cand, st)
                : launch_ranges<Sel, float, 8, 128>(q, x, nq, n_eff, d, k, n_ranges,
                                                    range_rows, kp, cand, st);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  const size_t smem2 = sizeof(int) * (size_t)n_ranges;
  e = cudaFuncSetAttribute(topk_merge_kernel<Sel>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (e != cudaSuccess) return (int)e;
  topk_merge_kernel<Sel><<<nq, THREADS, smem2, st>>>(cand, n_ranges, k, kp,
                                                     static_cast<float*>(out_v),
                                                     static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory pass 1 needs for a query tile of qt (8 or 32) at this k.
size_t topk_smem_bytes(int qt, int k) {
  return qt == 32 ? Tile<32, 64>::smem(k) : Tile<8, 128>::smem(k);
}

// q [nq, d], x [>= n_eff, d], both f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// only rows < n_eff are candidates. fast = 1 selects fast mode with
// lane_bits, chunk_log2 and n_chunks (ignored in exact mode). cand: [nq,
// n_ranges, k] 8-byte scratch; out_v/out_i: [nq, k]. Returns
// cudaGetLastError().
int topk_launch(const void* q, const void* x, int is_bf16, int nq, int n_eff, int d,
                int k, int qt, int n_ranges, int range_rows, int fast, int lane_bits,
                int chunk_log2, int n_chunks, void* cand, void* out_v, void* out_i,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const KeyParams kp{lane_bits, chunk_log2, n_chunks};
  if (fast)
    return launch<FastSel>(q, x, is_bf16, nq, n_eff, d, k, qt, n_ranges, range_rows, kp,
                           cand, out_v, out_i, st);
  return launch<ExactSel>(q, x, is_bf16, nq, n_eff, d, k, qt, n_ranges, range_rows, kp,
                          cand, out_v, out_i, st);
}

}  // extern "C"
