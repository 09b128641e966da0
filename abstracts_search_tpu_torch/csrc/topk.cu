// Streaming top-k of q . x^T for Hopper (sm_90a), exact and fast mode.
//
// Replaces abstracts_search_tpu/ops/topk.py::_topk_kernel (:184, exact
// mode, with its fold _fold_exact) and ::_topk_kernel_fast (:235, fast
// mode, keys _pack_keys/_unpack_keys). Scores accumulate in f32 and rows
// at or past n_valid never win.
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
// blocks in no order, so the corpus axis is split into ranges:
//   pass 1: block (range, query tile) scores its range a tile at a time.
//     The wgmma scan (bf16) appends each query's candidates -- scores at
//     or above a proven lower bound on its k-th best -- to a buffer in
//     device memory; the f32 scans keep a sorted top-k list per query in
//     shared memory and write them to a [Q, ranges, k] scratch.
//   pass 2: one block per query. topk_select_kernel selects the k best of
//     the wgmma scan's candidates (a radix select and a rank by counts);
//     topk_merge_kernel merges the f32 scans' sorted range lists head by
//     head (k rounds of a block-wide argmax over the heads). Both under the
//     same order.
//
// What bounds it: the corpus read, each byte once. At flat search's
// 2,097,152 x 1024 bf16 (4.29 GB) that is 1.28 ms at 3.35 TB/s; at the
// probe's 65,536 x 1024 bf16 centroids (128 MiB) 40 us. At Q 128 that is
// 128 flop per corpus byte, so reaching the bytes bound takes ~430
// TFLOP/s of bf16: tensor cores only.
//
// Pass 1 for bf16 operands (the serve probe at every nprobe, flat search,
// the tune oracle and sweep):
//   - tile product on tensor cores. tc::wg::range_kernel: four warpgroups
//     of wgmma.m64n128k16 (bf16 -> f32), both operands read straight from
//     shared memory. x [N, D] row-major is already the K-major B operand.
//     bf16 products are exact in f32; only the order of the sum differs
//     from the plain version.
//   - one corpus read for Q <= 256, at every k: a block holds 256 queries
//     (x 128 corpus rows per tile) or 128 (x 256), padded rows zero, so
//     the corpus streams once per query tile; Q above 256 loops over
//     tiles (grid y). Per query a block keeps 16 bytes of shared memory
//     (a count, its bound, a fold threshold), so k does not change the
//     queries it serves: sorted lists of k entries a query beside the
//     ring would cut them above k 16, leave the 128-row tile multiplying
//     masked rows and read the corpus once per query tile.
//   - staging without per-thread copies: one thread issues TMA tensor
//     copies of 64-deep slices into a 4-stage ring (an mbarrier per stage
//     counts the bytes), 128-byte swizzled as wgmma reads them; rows and
//     depth past the tensors' edges arrive as zeros. Each slice's wgmma
//     group stays in flight while the block frees the previous slice's
//     stage, across tile boundaries. Rows that are not 16-byte aligned
//     (d % 8 != 0) are staged by scalar loads into the same swizzle.
//   - selection from registers (append_tile): each score is compared with
//     its query's bound where the accumulator holds it. The bound is
//     shared between blocks: every lane keeps the top 4 of its rows of the
//     range and raises one of the query's ceil(k/4) bins in device memory
//     to its 4th best by atomicMax; the least bin is a proven lower bound,
//     read every tile (and, for k <= 16, the quad's own 4th bests bound a
//     range's first tile). Scores at or above it go to the (query, range)
//     buffer: 16-byte dense pieces when most of a quad's rows pass (a
//     range's first tile above k 16), else appended one by one. A buffer
//     past its level is folded to its k best in the kernel, whose k-th
//     then also bounds that buffer. After the first tiles almost nothing
//     passes. The accumulators are only read there: a write outside the
//     wgmma chain made ptxas serialize every wgmma (C7518).
//   - a grid sized to the card: one block per SM, and the wrapper's plan
//     sets the ranges so that the grid is one wave.
//
// Exact mode at k 1 over many bf16 queries (tc::kone::range_kernel, Q >=
// 257; the index build's assignment is Q 131,072-262,144 x 65,536 x 1024).
// What bounds it: operations, 2 Q N D at 989 TFLOP/s, 17.8 ms at Q 131,072;
// every query meets every centroid and only one (value, row) a query leaves.
// The wgmma scan above was built for Q <= 256 and, at this shape, was held
// by its staging (256 x 128 tiles: 85 flop per byte staged from L2, 206 GB
// a call), a 3-stage ring drained by wait_group 0 and __syncthreads every
// 64-deep step, and candidate lists sized for k in the thousands. The k-1
// scan instead:
//   - 128 x 256 tiles in 2-block clusters: both blocks walk the same
//     centroid tiles, and each loads half of a tile by one TMA multicast
//     into both rings, so a block stages 32 KiB from L2 per 4.2 MFLOP (128
//     flop a byte, 137 GB a call);
//   - a producer warpgroup (one thread issues, registers lowered by
//     setmaxnreg) and two consumer warpgroups of wgmma.m64n256k16 on a
//     4-stage ring with a full and an empty mbarrier a stage, one wgmma
//     group kept in flight, no __syncthreads in the loop. Each consumer
//     warp frees a stage in both blocks with a CTA-scope arrive: a
//     cluster-scope release there took the scan from 25.5 to 56 ms;
//   - the epilogue in registers (running_max): a running (max, lowest row)
//     per query row across the whole range, reduced over the 4 lanes that
//     share a row by shuffles, one entry a query written to the outputs,
//     no second pass when the range is the whole corpus. What is left: at
//     each tile's end both warpgroups drain their wgmma groups and run the
//     epilogue while the tensor cores wait (10-15% of the time at the build
//     shape, measured by leaving the epilogue out); with no loads at all
//     the scan takes ~90% of its time, so the bytes no longer hold it. It
//     ran at ~0.7 of the operations bound on an H100 (PERF.md).
//
// f32 operands (simt::range_kernel; Q <= 8 and very large k keep the
// f32-FMA scan, f32scan::range_kernel): TF32 would break the
// HIGHEST-precision contract of the f32 path, so the route is chosen by
// dtype, not as a fallback. What bounds it: operations at 67 TFLOP/s of
// f32 FMA (the IVF-Flat probe, Q 256 x 4,096 x 1,025: 32 us; plain-L2
// k-means' window, Q 262,144: 33 ms). The FMA scan it replaced staged
// element by element behind two __syncthreads a step and fed 8 FMAs from
// 6 shared-memory loads. The register-blocked scan holds 8 queries x 8
// (or 4) rows a thread, reads float4 fragments (16 loads per 256 FMAs),
// stages by TMA into a 4-stage ring, and selects from the registers; the
// 64-query tile (the probe) spreads 8 warps over the rows so that the
// probe's 128 blocks hold 8 warps each. What is left: its FMA loop issues
// at ~0.67 of the f32 peak with 8 warps of 254 registers an SM.
// No --use_fast_math: decoded fast-mode values may be denormal.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int IDX_NONE = 0x7fffffff;    // empty list slot (exact mode)
constexpr unsigned FULL = 0xffffffffu;
constexpr int MERGE_THREADS = 256;

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
  // a score in the form above(), level() and made() take: the score itself
  static __device__ __forceinline__ float prep(float s, const KeyParams&) { return s; }
  // order of prepared scores, and the lowest one
  static __device__ __forceinline__ bool below(float a, float b) { return a < b; }
  static __device__ __forceinline__ float bottom() { return -INFINITY; }
  // the larger and the smaller of two prepared scores
  static __device__ __forceinline__ float hi2(float a, float b) { return fmaxf(a, b); }
  static __device__ __forceinline__ float lo2(float a, float b) { return fminf(a, b); }
  static __device__ __forceinline__ E made(float s, int row, const KeyParams&) {
    return {s, row};
  }
  // better(made(s, row), th) is above(s, th) || (level(s, th) && row_wins(row, th))
  static __device__ __forceinline__ bool above(float s, E th) { return s > th.v; }
  static __device__ __forceinline__ bool level(float s, E th) { return s == th.v; }
  static __device__ __forceinline__ bool row_wins(int row, E th, const KeyParams&) {
    return row < th.i;
  }
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
  // The wgmma scan's keys: an unsigned word ordered as the prepared scores
  // (larger is better; every score's word is above 0), and a 64-bit key
  // unique to the row, ordered as better(). -0 keys as +0: they compare equal.
  static __device__ __forceinline__ uint32_t vkey(float s) {
    const uint32_t u = __float_as_uint(s + 0.0f);
    return u ^ ((uint32_t)((int)u >> 31) | 0x80000000u);
  }
  static __device__ __forceinline__ uint64_t key(uint32_t vk, int row, const KeyParams&) {
    return ((uint64_t)vk << 32) | (uint32_t)~row;
  }
  // the prepared score of a word (bottom() for 0)
  static __device__ __forceinline__ float unvkey(uint32_t vk) {
    return vk == 0 ? -INFINITY : __uint_as_float((vk & 0x80000000u) ? vk ^ 0x80000000u : ~vk);
  }
  static __device__ __forceinline__ E from_key(uint64_t kk) {
    const uint32_t vk = (uint32_t)(kk >> 32);
    return {__uint_as_float((vk & 0x80000000u) ? vk ^ 0x80000000u : ~vk), (int)~(uint32_t)kk};
  }
};

// Fast mode: one unique int64 key (see the header), larger is better.
struct FastSel {
  using E = long long;
  static __device__ __forceinline__ E none() { return (long long)INT64_MIN; }
  static __device__ __forceinline__ int hi(float s, const KeyParams& p) {
    const int si = __float_as_int(s);
    const int key = si ^ ((si >> 31) & 0x7fffffff);   // signed order = float order
    return key >> p.lane_bits;                         // arithmetic: truncates
  }
  static __device__ __forceinline__ unsigned lo(int row, const KeyParams& p) {
    const unsigned chunk = (unsigned)row >> p.chunk_log2;
    const unsigned lane = (unsigned)row & ((1u << p.chunk_log2) - 1u);
    return (((unsigned)p.n_chunks - 1u - chunk) << p.chunk_log2) | lane;
  }
  static __device__ __forceinline__ E make(float s, int row, const KeyParams& p) {
    return (long long)(((unsigned long long)(long long)hi(s, p) << 32) | lo(row, p));
  }
  static __device__ __forceinline__ bool better(E a, E b) { return a > b; }
  // a score in the form above(), level() and made() take: its truncated key's
  // high word, carried in the float's bits
  static __device__ __forceinline__ float prep(float s, const KeyParams& p) {
    return __int_as_float(hi(s, p));
  }
  // order of prepared scores, and the lowest one
  static __device__ __forceinline__ bool below(float a, float b) {
    return __float_as_int(a) < __float_as_int(b);
  }
  static __device__ __forceinline__ float bottom() { return __int_as_float(INT_MIN); }
  static __device__ __forceinline__ float hi2(float a, float b) {
    return __int_as_float(max(__float_as_int(a), __float_as_int(b)));
  }
  static __device__ __forceinline__ float lo2(float a, float b) {
    return __int_as_float(min(__float_as_int(a), __float_as_int(b)));
  }
  static __device__ __forceinline__ E made(float s, int row, const KeyParams& p) {
    return (long long)(((unsigned long long)(long long)__float_as_int(s) << 32) | lo(row, p));
  }
  // better(made(s, row), th) is above(s, th) || (level(s, th) && row_wins(row, th))
  static __device__ __forceinline__ bool above(float s, E th) {
    return __float_as_int(s) > (int)(th >> 32);
  }
  static __device__ __forceinline__ bool level(float s, E th) {
    return __float_as_int(s) == (int)(th >> 32);
  }
  static __device__ __forceinline__ bool row_wins(int row, E th, const KeyParams& p) {
    return lo(row, p) > (unsigned)(unsigned long long)th;
  }
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
  // The wgmma scan's keys (see ExactSel): the entry with its sign bit
  // flipped, so that unsigned order is better()'s
  static __device__ __forceinline__ uint32_t vkey(float s) {
    return (uint32_t)__float_as_int(s) ^ 0x80000000u;
  }
  static __device__ __forceinline__ uint64_t key(uint32_t vk, int row, const KeyParams& p) {
    return ((uint64_t)vk << 32) | lo(row, p);
  }
  static __device__ __forceinline__ float unvkey(uint32_t vk) {
    return __int_as_float((int)(vk ^ 0x80000000u));
  }
  static __device__ __forceinline__ E from_key(uint64_t kk) {
    return (long long)(kk ^ 0x8000000000000000ull);
  }
};

static_assert(sizeof(ExactSel::E) == 8 && sizeof(FastSel::E) == 8, "8-byte entries");

// ---------------------------------------------------------------------------
// f32 operands at Q <= 8, or at a k whose lists the register-blocked scan
// (simt:: below) cannot hold: f32 FMAs from shared memory, insertion into
// sorted lists. Instantiated at 8 queries x 128 rows a block.

namespace f32scan {

constexpr int THREADS = 256;
constexpr int DK = 32;                  // depth staged per step

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

template <typename Sel, int QT, int TN>
__global__ void __launch_bounds__(THREADS) range_kernel(
    const float* __restrict__ q, const float* __restrict__ x, int nq, int n_eff, int d,
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
        qs[e] = (gq < nq && gd < d) ? q[(size_t)gq * d + gd] : 0.f;
      }
      for (int e = t; e < TN * DK; e += THREADS) {
        const int ri = e / DK, dd = e % DK, gr = r0 + ri, gd = d0 + dd;
        xs[ri * (DK + 1) + dd] = (gr < r_end && gd < d) ? x[(size_t)gr * d + gd] : 0.f;
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

}  // namespace f32scan

// ---------------------------------------------------------------------------
// bf16 operands: tensor cores, selection from the accumulator fragments.

namespace tc {

constexpr int DK = 64;   // depth per stage: 128-byte rows

// byte offset of 16-byte chunk c of staged row r, XOR-swizzled by r & 7
// (the 128-byte swizzle of TMA and of wgmma's shared-memory descriptors)
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// Stage depth slice [d0, d0 + DK) of the block's queries [q0, q0 + qlim)
// (staged rows 0..QT-1) and corpus rows [r0, r_end) (rows QT..QT+TN-1)
// by scalar loads, zero past either edge and past d: the staging of rows
// TMA cannot copy (not 16-byte aligned).
template <int QT, int TN, int THREADS>
__device__ __forceinline__ void load_stage(uint32_t sbase, const __nv_bfloat16* q,
                                           const __nv_bfloat16* x, int q0, int qlim,
                                           int r0, int r_end, int d0, int d, int t) {
  constexpr int CH = DK / 8;   // 16-byte chunks per row
  for (int e = t; e < (QT + TN) * CH; e += THREADS) {
    const int row = e / CH, c = e % CH, gd = d0 + c * 8;
    const __nv_bfloat16* src;
    bool ok;
    if (row < QT) {
      ok = row < qlim;
      src = q + (size_t)(q0 + row) * d + gd;
    } else {
      const int gr = r0 + row - QT;
      ok = gr < r_end;
      src = x + (size_t)gr * d + gd;
    }
    unsigned short h[8];
    const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
    for (int j = 0; j < 8; ++j) h[j] = (ok && gd + j < d) ? s16[j] : (unsigned short)0;
    const uint32_t w0 = h[0] | ((uint32_t)h[1] << 16), w1 = h[2] | ((uint32_t)h[3] << 16);
    const uint32_t w2 = h[4] | ((uint32_t)h[5] << 16), w3 = h[6] | ((uint32_t)h[7] << 16);
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(sbase + swz(row, c)),
                 "r"(w0), "r"(w1), "r"(w2), "r"(w3));
  }
}

// Merge n (<= G) candidates C into the sorted list L[k] of one query; a
// group of G lanes (gl: the lane in the group), 32 or, for k <= 16, 16 so
// that a warp folds two queries at once. Every element goes to its rank in
// the union: candidate j to (candidates better than it) + (list entries
// better than it), a list entry at p to p + (candidates better than it).
// Entries of the order are unique apart from empty slots, which all sort
// last, so the ranks are a permutation. Cost grows with n: a fold after
// the first tiles is short. Called by every lane of the warp.
template <typename Sel, int G>
__device__ __forceinline__ void fold(typename Sel::E* L, typename Sel::E* C, int n, int k,
                                     int gl, const KeyParams& kp) {
  using E = typename Sel::E;
  E c = Sel::none();
  if (gl < n) {   // the buffer holds (prepared score, row): make the entries
    const int2 sr = reinterpret_cast<const int2*>(C)[gl];
    c = Sel::made(__int_as_float(sr.x), sr.y, kp);
  }
  __syncwarp();
  if (gl < n) C[gl] = c;
  __syncwarp();
  const E e0 = n > 0 && gl < k ? L[gl] : Sel::none();
  int rc = 0, r0 = 0;  // candidates better than c, than e0
  for (int i = 0; i < n; ++i) {
    const E o = C[i];
    rc += Sel::better(o, c);
    r0 += Sel::better(o, e0);
  }
  int pc = IDX_NONE;  // candidate's rank in the union
  if (gl < n) {
    int lo = 0, hi = k;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (Sel::better(L[mid], c)) lo = mid + 1;
      else hi = mid;
    }
    pc = rc + lo;
  }
  // list entries move up only: highest block of G first, candidates last
  for (int base = ((k - 1) / G) * G; base > 0; base -= G) {
    const int p = base + gl;
    const E e = n > 0 && p < k ? L[p] : Sel::none();
    int r = 0;
    for (int i = 0; i < n; ++i) r += Sel::better(C[i], e);
    __syncwarp();
    if (p < k && r > 0 && p + r < k) L[p + r] = e;
    __syncwarp();
  }
  __syncwarp();
  if (gl < k && r0 > 0 && gl + r0 < k) L[gl + r0] = e0;
  __syncwarp();
  if (pc < k) L[pc] = c;
  __syncwarp();
}

// Fold every non-empty candidate buffer into its list; warps take queries
// in turn, two at a time when k and CB allow 16-lane folds.
template <typename Sel, int WARPS, int CB>
__device__ __forceinline__ void fold_all(typename Sel::E* lst, typename Sel::E* cbuf, int* cnt,
                                         int qlim, int k, int warp, int lane,
                                         const KeyParams& kp) {
  if (CB <= 16 && k <= 16) {
    for (int q2 = 2 * warp; q2 < qlim; q2 += 2 * WARPS) {
      const int ql = q2 + (lane >> 4);
      const int n = ql < qlim ? min(cnt[ql], CB) : 0;
      if (!__any_sync(FULL, n > 0)) continue;
      fold<Sel, 16>(lst + (size_t)ql * k, cbuf + ql * CB, n, k, lane & 15, kp);
      if ((lane & 15) == 0 && n > 0) cnt[ql] = 0;
    }
    return;
  }
  for (int ql = warp; ql < qlim; ql += WARPS) {
    const int n = min(cnt[ql], CB);
    if (n == 0) continue;
    fold<Sel, 32>(lst + (size_t)ql * k, cbuf + ql * CB, n, k, lane, kp);
    if (lane == 0) cnt[ql] = 0;
  }
}

// Offer the block's tile of scores to the per-query lists. acc[i][j][v]
// (an m16n8 fragment layout) holds query qoff + 16i + g + 8(v >> 1) and row
// r0 + roff + 8j + 2tg + (v & 1); it is overwritten. A score that beats its
// query's k-th entry goes to the query's candidate buffer; when a buffer is
// full, every buffer is folded into its list and the scores left over retry
// against the raised thresholds. Called by every thread of the block.
template <typename Sel, int MT, int NT, int WARPS, int CB>
__device__ __forceinline__ void select_tile(float (&acc)[MT][NT][4], int qoff,
                                            int roff, int r0, int r_end, int qlim, int k,
                                            typename Sel::E* lst, typename Sel::E* cbuf,
                                            int* cnt, const KeyParams& kp, int warp,
                                            int lane) {
  using E = typename Sel::E;
  static_assert(2 * NT <= 32, "one pending bit per score of a query");
  const int g = lane >> 2, tg = lane & 3;
  const int rbase0 = r0 + roff + 2 * tg;
  // pend[i][h] bit 2j + c: score acc[i][j][2h + c] (query qoff + 16i + g +
  // 8h, row rbase + 8j + c) still to be offered
  uint32_t rows = 0;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) rows |= (uint32_t)(rbase0 + 8 * j + c < r_end) << (2 * j + c);
  uint32_t pend[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pend[i][h] = qoff + i * 16 + g + 8 * h < qlim ? rows : 0u;
#pragma unroll
      for (int j = 0; j < NT; ++j)   // once, not in every round
#pragma unroll
        for (int c = 0; c < 2; ++c)
          acc[i][j][2 * h + c] = Sel::prep(acc[i][j][2 * h + c], kp);
    }
  // A query whose list is not full yet (the first tile of a range) would
  // take every score. The 4 lanes of a quad hold one query's scores here:
  // the lowest of their 4th-best scores has at least 16 scores of the tile
  // at or above it, so for k <= 16 a score below it never makes the list.
  float floor_[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ql = qoff + i * 16 + g + 8 * h;
      float t0 = Sel::bottom(), t1 = t0, t2 = t0, t3 = t0;
      if (k <= 16 && ql < qlim && Sel::empty(lst[(size_t)ql * k + k - 1])) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float x = acc[i][j][2 * h + c];
            if (!((pend[i][h] >> (2 * j + c)) & 1) || !Sel::below(t3, x)) continue;
            t3 = x;
            if (Sel::below(t2, t3)) { const float y = t2; t2 = t3; t3 = y; }
            if (Sel::below(t1, t2)) { const float y = t1; t1 = t2; t2 = y; }
            if (Sel::below(t0, t1)) { const float y = t0; t0 = t1; t1 = y; }
          }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {   // the quad shares the query
        const float y = __shfl_xor_sync(FULL, t3, o);
        if (Sel::below(y, t3)) t3 = y;
      }
      floor_[i][h] = t3;
    }
  int rbase = rbase0;
  while (true) {
    // rows are cheap to recompute: keep the compiler from holding a key
    // word per row across the rounds
    asm volatile("" : "+r"(rbase));
    bool left = false;  // a score found its query's buffer full
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (!pend[i][h]) continue;
        const int ql = qoff + i * 16 + g + 8 * h;
        const E th = lst[(size_t)ql * k + k - 1];
        uint32_t up = 0, lv = 0, lo = 0;   // above, level with, below the floor
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float x = acc[i][j][2 * h + c];
            up |= (uint32_t)Sel::above(x, th) << (2 * j + c);
            lv |= (uint32_t)Sel::level(x, th) << (2 * j + c);
            lo |= (uint32_t)Sel::below(x, floor_[i][h]) << (2 * j + c);
          }
        const uint32_t live = pend[i][h] & ~lo;
        uint32_t pass = live & up, tie = live & lv & ~up;
        pend[i][h] = pass | tie;   // the rest can never make the list
        while (tie) {   // rare: rows only here
          const int b = __ffs(tie) - 1;
          tie &= tie - 1;
          if (Sel::row_wins(rbase + 8 * (b >> 1) + (b & 1), th, kp)) pass |= 1u << b;
          else pend[i][h] &= ~(1u << b);
        }
        if (!pass) continue;
        int pos = atomicAdd(&cnt[ql], __popc(pass));
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            if (!((pass >> (2 * j + c)) & 1)) continue;
            if (pos < CB) {   // (prepared score, row): fold() makes the entry
              reinterpret_cast<int2*>(cbuf)[ql * CB + pos] =
                  make_int2(__float_as_int(acc[i][j][2 * h + c]), rbase + j * 8 + c);
              pend[i][h] &= ~(1u << (2 * j + c));
            } else {
              left = true;
            }
            ++pos;
          }
      }
    if (!__syncthreads_or(left)) break;
    fold_all<Sel, WARPS, CB>(lst, cbuf, cnt, qlim, k, warp, lane, kp);
    __syncthreads();
  }
}

// Exact mode at k 1: fold a tile of scores into each query's running
// (max, lowest row), all in registers. acc[i][j][v] is laid out as in
// select_tile; rbase is this thread's first row (r0 + roff + 2tg), so its
// rows rbase + 8j + c ascend with (j, c); rows >= r_end are left out. The
// tile's maximum rarely beats the running one after the first tiles; only
// then is its lowest row looked for. Tiles arrive in ascending row order,
// so an equal later score never displaces. (A tree of fmaxf in place of
// the chain needs 2 NT more registers: beside the k-1 scan's 128 sums,
// ptxas then waits on the wgmma groups early, and the scan took 31-33 ms,
// not 25.5, at the build shape on an H100; tools/topk_variants.py.)
template <int MT, int NT>
__device__ __forceinline__ void running_max(const float (&acc)[MT][NT][4], float (&rv)[MT][2],
                                            int (&ri)[MT][2], int rbase, int r_end) {
  const bool edge = rbase + 8 * (NT - 1) + 1 >= r_end;   // some row of this thread past the end
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if (!edge || rbase + 8 * j + c < r_end) m = fmaxf(m, acc[i][j][2 * h + c]);
      if (m > rv[i][h]) {
        // the lowest row holding m (rows past the end are above every valid one)
        int col = 0;
        float val = m;
#pragma unroll
        for (int j = NT - 1; j >= 0; --j)
#pragma unroll
          for (int c = 1; c >= 0; --c)
            if (acc[i][j][2 * h + c] == m) {
              col = 8 * j + c;
              val = acc[i][j][2 * h + c];
            }
        rv[i][h] = val;
        ri[i][h] = rbase + col;
      }
    }
}

// The 4 lanes of a quad (same g) share their queries: reduce the running
// (max, lowest row) across them, ties to the lowest row.
template <int MT>
__device__ __forceinline__ void quad_max(float (&rv)[MT][2], int (&ri)[MT][2]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float ov = __shfl_xor_sync(FULL, rv[i][h], o);
        const int oi = __shfl_xor_sync(FULL, ri[i][h], o);
        if (ov > rv[i][h] || (ov == rv[i][h] && oi < ri[i][h])) {
          rv[i][h] = ov;
          ri[i][h] = oi;
        }
      }
}

// A query's k-1 result: to the outputs when the range is the whole corpus
// (cand null: no second pass), else to its range's scratch entry.
__device__ __forceinline__ void put_k1(float v, int i, int gq, ExactSel::E* cand, int n_ranges,
                                       int range, float* out_v, int* out_i) {
  const ExactSel::E e{v, i};
  if (cand) cand[(size_t)gq * n_ranges + range] = e;
  else ExactSel::out(e, KeyParams{}, &out_v[gq], &out_i[gq]);
}

template <typename Sel>
__device__ __forceinline__ void init_lists(typename Sel::E* lst, int* cnt, int qb, int k,
                                           int t, int threads) {
  for (int e = t; e < qb * k; e += threads) lst[e] = Sel::none();
  for (int e = t; e < qb; e += threads) cnt[e] = 0;
}

template <typename Sel, int WARPS, int CB>
__device__ __forceinline__ void finish(typename Sel::E* lst, typename Sel::E* cbuf, int* cnt,
                                       int q0, int qlim, int k, int t, int threads,
                                       const KeyParams& kp, typename Sel::E* __restrict__ cand) {
  __syncthreads();
  fold_all<Sel, WARPS, CB>(lst, cbuf, cnt, qlim, k, t >> 5, t & 31, kp);
  __syncthreads();
  for (int e = t; e < qlim * k; e += threads) {
    const int ql = e / k, p = e % k;
    cand[((size_t)(q0 + ql) * gridDim.x + blockIdx.x) * k + p] = lst[e];
  }
}

// -- wgmma scan: 4 warpgroups, each an m64n128 tile (64 queries x 128
// corpus rows) of wgmma.m64n128k16, both operands read straight from
// 128-byte-swizzled shared memory; WM x WN warpgroups over queries x rows.
// Selection keeps no per-query list in the block, so the queries a block
// serves do not depend on k: per query it holds a count and two thresholds
// (16 bytes), and the candidates go to device memory (see append_tile).

namespace wg {

template <int WM_, int WN_, int STAGES_>
struct Cfg {
  static constexpr int WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr int THREADS = 128 * WM * WN;
  static constexpr int QT = 64 * WM;    // query rows per tile (a block serves qb <= QT)
  static constexpr int TN = 128 * WN;   // corpus rows per tile
  static constexpr int STAGE_BYTES = (QT + TN) * DK * 2;
  static constexpr int FOLD_PER_THREAD = 8;   // a fold holds cap <= 8 x THREADS keys
  static_assert(STAGE_BYTES % 1024 == 0, "swizzle atoms 1024-byte aligned");
  // 1 KiB to align the stages, the stages, 64 bytes of stage barriers,
  // then per query its fold threshold (8 bytes), its candidate count and
  // its bound from the shared bins (4 bytes each), 16 bytes of block
  // scratch, and per thread the top 4 of each of its two query rows (32
  // bytes: in registers they pushed the scan's into local memory)
  static constexpr size_t SMEM =
      1024 + (size_t)STAGES * STAGE_BYTES + 64 + 16 * (size_t)QT + 16 + 32 * (size_t)THREADS;
  static_assert(STAGES * 8 <= 64, "stage barriers");
};

using Mid = Cfg<2, 2, 4>;     // 128 queries x 256 rows
using Large = Cfg<4, 1, 4>;   // 256 queries x 128 rows

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// box {64 deep, rows} at (depth c0, row c1), zero past the tensor's edges
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_operands(float (&d)[1][16][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) asm volatile("" : "+f"(d[0][j][v])::"memory");
}

// d += a b
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[1][16][4], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0][0]), "+f"(d[0][0][1]), "+f"(d[0][0][2]), "+f"(d[0][0][3]),
        "+f"(d[0][1][0]), "+f"(d[0][1][1]), "+f"(d[0][1][2]), "+f"(d[0][1][3]),
        "+f"(d[0][2][0]), "+f"(d[0][2][1]), "+f"(d[0][2][2]), "+f"(d[0][2][3]),
        "+f"(d[0][3][0]), "+f"(d[0][3][1]), "+f"(d[0][3][2]), "+f"(d[0][3][3]),
        "+f"(d[0][4][0]), "+f"(d[0][4][1]), "+f"(d[0][4][2]), "+f"(d[0][4][3]),
        "+f"(d[0][5][0]), "+f"(d[0][5][1]), "+f"(d[0][5][2]), "+f"(d[0][5][3]),
        "+f"(d[0][6][0]), "+f"(d[0][6][1]), "+f"(d[0][6][2]), "+f"(d[0][6][3]),
        "+f"(d[0][7][0]), "+f"(d[0][7][1]), "+f"(d[0][7][2]), "+f"(d[0][7][3]),
        "+f"(d[0][8][0]), "+f"(d[0][8][1]), "+f"(d[0][8][2]), "+f"(d[0][8][3]),
        "+f"(d[0][9][0]), "+f"(d[0][9][1]), "+f"(d[0][9][2]), "+f"(d[0][9][3]),
        "+f"(d[0][10][0]), "+f"(d[0][10][1]), "+f"(d[0][10][2]), "+f"(d[0][10][3]),
        "+f"(d[0][11][0]), "+f"(d[0][11][1]), "+f"(d[0][11][2]), "+f"(d[0][11][3]),
        "+f"(d[0][12][0]), "+f"(d[0][12][1]), "+f"(d[0][12][2]), "+f"(d[0][12][3]),
        "+f"(d[0][13][0]), "+f"(d[0][13][1]), "+f"(d[0][13][2]), "+f"(d[0][13][3]),
        "+f"(d[0][14][0]), "+f"(d[0][14][1]), "+f"(d[0][14][2]), "+f"(d[0][14][3]),
        "+f"(d[0][15][0]), "+f"(d[0][15][1]), "+f"(d[0][15][2]), "+f"(d[0][15][3])
      : "l"(da), "l"(db), "r"(1));
}

// d = a b: a tile's first product; the old sums are not read, so nothing
// keeps them live between tiles
__device__ __forceinline__ void wgmma_m64n128k16_first(float (&d)[1][16][4], uint64_t da,
                                                       uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "=f"(d[0][0][0]), "=f"(d[0][0][1]), "=f"(d[0][0][2]), "=f"(d[0][0][3]),
        "=f"(d[0][1][0]), "=f"(d[0][1][1]), "=f"(d[0][1][2]), "=f"(d[0][1][3]),
        "=f"(d[0][2][0]), "=f"(d[0][2][1]), "=f"(d[0][2][2]), "=f"(d[0][2][3]),
        "=f"(d[0][3][0]), "=f"(d[0][3][1]), "=f"(d[0][3][2]), "=f"(d[0][3][3]),
        "=f"(d[0][4][0]), "=f"(d[0][4][1]), "=f"(d[0][4][2]), "=f"(d[0][4][3]),
        "=f"(d[0][5][0]), "=f"(d[0][5][1]), "=f"(d[0][5][2]), "=f"(d[0][5][3]),
        "=f"(d[0][6][0]), "=f"(d[0][6][1]), "=f"(d[0][6][2]), "=f"(d[0][6][3]),
        "=f"(d[0][7][0]), "=f"(d[0][7][1]), "=f"(d[0][7][2]), "=f"(d[0][7][3]),
        "=f"(d[0][8][0]), "=f"(d[0][8][1]), "=f"(d[0][8][2]), "=f"(d[0][8][3]),
        "=f"(d[0][9][0]), "=f"(d[0][9][1]), "=f"(d[0][9][2]), "=f"(d[0][9][3]),
        "=f"(d[0][10][0]), "=f"(d[0][10][1]), "=f"(d[0][10][2]), "=f"(d[0][10][3]),
        "=f"(d[0][11][0]), "=f"(d[0][11][1]), "=f"(d[0][11][2]), "=f"(d[0][11][3]),
        "=f"(d[0][12][0]), "=f"(d[0][12][1]), "=f"(d[0][12][2]), "=f"(d[0][12][3]),
        "=f"(d[0][13][0]), "=f"(d[0][13][1]), "=f"(d[0][13][2]), "=f"(d[0][13][3]),
        "=f"(d[0][14][0]), "=f"(d[0][14][1]), "=f"(d[0][14][2]), "=f"(d[0][14][3]),
        "=f"(d[0][15][0]), "=f"(d[0][15][1]), "=f"(d[0][15][2]), "=f"(d[0][15][3])
      : "l"(da), "l"(db), "r"(0));
}

// Sorting networks on prepared scores, larger first: a pair, four values,
// and the top 4 of two sorted 4-lists into the first (the elementwise
// larger of one list and the other reversed holds the top 4 as a bitonic
// sequence, which two rounds sort). No compare feeds the next score's, so
// a lane's 32 scores keep the pipelines full where an insertion chain
// waited on itself (~6 us a tile at the probe).
template <typename Sel>
__device__ __forceinline__ void order2(float& a, float& b) {
  const float h = Sel::hi2(a, b), l = Sel::lo2(a, b);
  a = h;
  b = l;
}
template <typename Sel>
__device__ __forceinline__ void sort4(float (&a)[4]) {
  order2<Sel>(a[0], a[1]), order2<Sel>(a[2], a[3]), order2<Sel>(a[0], a[2]);
  order2<Sel>(a[1], a[3]), order2<Sel>(a[1], a[2]);
}
template <typename Sel>
__device__ __forceinline__ void top4_merge(float (&a)[4], const float (&b)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = Sel::hi2(a[i], b[3 - i]);
  order2<Sel>(a[0], a[2]), order2<Sel>(a[1], a[3]), order2<Sel>(a[0], a[1]);
  order2<Sel>(a[2], a[3]);
}

// One (query, range)'s candidate buffer holds more than its fold level:
// keep its k best keys, moved to the buffer's front, and make the k-th its
// threshold (only better keys enter from now on); with k or fewer keys
// (the rest of its n slots zero: dense tiles' rows that did not pass) just
// move them to the front. The k-th best is found bit by bit, from the top,
// each bit by a block-wide count. The count stays even (a zero pads it),
// so dense tiles start 16-byte aligned. Called by every thread for every
// query whose buffer passed the level (rare: the shared bound keeps most
// scores out), between tiles; out of line, so that its registers do not
// weigh on the scan's.
template <class C>
__device__ __noinline__ void fold_full(uint64_t* __restrict__ b, int n, int k, uint64_t* thr,
                                       int* cnt, int* scratch, int t) {
  constexpr int FE = C::FOLD_PER_THREAD;
  const int fe = (n + C::THREADS - 1) / C::THREADS;
  uint64_t kv[FE];
  int m = 0;   // keys (not zero)
#pragma unroll
  for (int i = 0; i < FE; ++i) {
    const int e = t + i * C::THREADS;
    kv[i] = i < fe && e < n ? __ldcg(reinterpret_cast<const unsigned long long*>(b) + e) : 0ull;
    if (i < fe) m += __syncthreads_count(kv[i] != 0);
  }
  uint64_t th = 1;   // every key is at or above 1
  if (m > k) {
    th = 0;
    for (int bit = 63; bit >= 0; --bit) {
      const uint64_t c = th | (1ull << bit);
      int above = 0;
#pragma unroll
      for (int i = 0; i < FE; ++i)
        if (i < fe) above += __syncthreads_count(kv[i] >= c);
      if (above >= k) th = c;
    }
  }
  if (t == 0) *scratch = 0;
  __syncthreads();   // every key read; the position counter zeroed
#pragma unroll
  for (int i = 0; i < FE; ++i)
    if (i < fe && kv[i] >= th) b[atomicAdd(scratch, 1)] = kv[i];   // keys unique
  if (t == 0) {
    const int kept = min(m, k);
    if (kept & 1) b[kept] = 0;
    if (m > k) *thr = th;
    *cnt = kept + (kept & 1);
  }
}

// Offer the block's tile of scores to the candidate buffers. acc[0][j][v]
// (an m16n8 fragment layout) holds query ql = qoff + g + 8(v >> 1) and row
// r0 + roff + 8j + 2tg + (v & 1); it is only read (a write here would make
// ptxas serialize the next tile's wgmma). A score passes when its word is
// at or above its query's bound -- a proven lower bound on the query's
// k-th best score -- and, after a fold, its key is above the buffer's
// threshold. The bound is the larger of:
//   - the shared bins: every lane keeps its own top 4 of the range (its
//     rows are a source no other lane sees) and raises bin (source mod
//     nbins) of the query to its 4th best by atomicMax; each of nbins >=
//     k/4 bins holds a 4th best of a distinct source, so the least bin has
//     at least k rows at or above it. Read every tile, after this tile's
//     raises: once the ranges' first tiles are in, it stands near the k-th
//     best of the corpus;
//   - for k <= 16, the quad's floor: the 4 lanes that share the query hold
//     4 rows each at or above their 4th best, so the ceil(k/4)-th largest
//     of those bounds the k-th best.
// "At or above": a score equal to the bound may still win on its row.
// Passing keys go to the (query, range) buffer in device memory (the
// wrapper's [Q, ranges, cap] scratch): when a quad's 128 rows pass in
// numbers (a range's first tile above k 16), the quad writes all 128 slots
// in 16-byte pieces, zero where a row did not pass; otherwise each lane
// appends its own, an even count (a zero pads it). A tile adds at most TN
// + 8 slots a query, and a buffer is folded once it holds more than cap -
// TN - 8, so an append always finds room. Called by every thread.
template <typename Sel, class C>
__device__ __forceinline__ void append_tile(const float (&acc)[1][16][4], uint32_t* top,
                                            int qoff, int roff, int r0, int r_end, int qlim,
                                            int q0, int k, int cap, int nbins, int src,
                                            uint64_t* thr, int* cnt, uint32_t* gb, int* scratch,
                                            uint64_t* __restrict__ buf,
                                            uint32_t* __restrict__ bins, const KeyParams& kp,
                                            int t, int lane) {
  constexpr int DENSE = 24;   // passing rows of a quad's 128 from which it writes them all
  const int g = lane >> 2, tg = lane & 3;
  const int rbase = r0 + roff + 2 * tg;
  uint32_t rows = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) rows |= (uint32_t)(rbase + 8 * j + c < r_end) << (2 * j + c);
  uint32_t fl[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ql = qoff + g + 8 * h;
    const uint32_t valid = ql < qlim ? rows : 0u;
    // this thread's top 4 of the row over the range (words in shared
    // memory), merged with the tile's by sorting networks, 8 scores a step
    uint32_t* tp = top + (4 * h) * C::THREADS + t;
    const uint32_t old3 = tp[3 * C::THREADS];
    float r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] = Sel::unvkey(tp[i * C::THREADS]);
#pragma unroll
    for (int j0 = 0; j0 < 16; j0 += 4) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = j0 + i;
        a[i] = (valid >> (2 * j)) & 1 ? Sel::prep(acc[0][j][2 * h], kp) : Sel::bottom();
        b[i] = (valid >> (2 * j + 1)) & 1 ? Sel::prep(acc[0][j][2 * h + 1], kp) : Sel::bottom();
      }
      sort4<Sel>(a);
      sort4<Sel>(b);
      top4_merge<Sel>(a, b);
      top4_merge<Sel>(r, a);
    }
    const uint32_t w3 = Sel::vkey(r[3]);
#pragma unroll
    for (int i = 0; i < 3; ++i) tp[i * C::THREADS] = Sel::vkey(r[i]);
    tp[3 * C::THREADS] = w3;
    // a 4th best at or below the bound last read raises no bin (each is at
    // or above it): most lanes after the first tiles, sparing the bins'
    // atomics their contention
    if (nbins > 0 && w3 > old3 && ql < qlim && w3 > gb[ql])
      atomicMax(bins + (size_t)(q0 + ql) * nbins + src % nbins, w3);
    // the quad's floor (k <= 16): the ceil(k/4)-th largest of its 4th bests
    uint32_t a0 = w3, a1 = __shfl_xor_sync(FULL, w3, 1);
    uint32_t a2 = __shfl_xor_sync(FULL, w3, 2), a3 = __shfl_xor_sync(FULL, a1, 2);
    auto order = [](uint32_t& x, uint32_t& y) {
      if (x < y) { const uint32_t z = x; x = y; y = z; }
    };
    order(a0, a1), order(a2, a3), order(a0, a2), order(a1, a3), order(a1, a2);
    fl[h] = k > 16 ? 0u : k <= 4 ? a0 : k <= 8 ? a1 : k <= 12 ? a2 : a3;
  }
  if (nbins > 0) {   // the bound from the bins, TPQ adjacent threads a query
    constexpr int TPQ = C::THREADS / C::QT;
    const int ql = t / TPQ, part = t % TPQ;
    uint32_t v = 0xffffffffu;
    if (ql < qlim) {
      const uint32_t* b = bins + (size_t)(q0 + ql) * nbins;
      for (int i = part; i < nbins; i += TPQ) v = min(v, __ldcg(b + i));
    }
#pragma unroll
    for (int o = 1; o < TPQ; o <<= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
    if (part == 0 && ql < qlim) gb[ql] = max(gb[ql], v);
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ql = qoff + g + 8 * h;
    uint32_t pass = 0;
    uint64_t* dst = buf;
    if (ql < qlim) {
      const float lim = Sel::unvkey(max(fl[h], gb[ql]));
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          pass |= (uint32_t)!Sel::below(Sel::prep(acc[0][j][2 * h + c], kp), lim) << (2 * j + c);
      pass &= rows;
      const uint64_t th = thr[ql];   // 0 until the buffer's first fold
      if (th != 0 && pass) {   // after a fold, only keys above the buffer's k-th
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (Sel::key(Sel::vkey(Sel::prep(acc[0][j][2 * h + c], kp)), rbase + 8 * j + c,
                         kp) <= th)
              pass &= ~(1u << (2 * j + c));
      }
      dst += ((size_t)(q0 + ql) * gridDim.x + blockIdx.x) * cap;
    }
    int np = __popc(pass);   // the quad's passing rows (its lanes share ql)
    np += __shfl_xor_sync(FULL, np, 1);
    np += __shfl_xor_sync(FULL, np, 2);
    if (np >= DENSE) {   // all 128 slots, 16 bytes a lane and column
      int base = 0;
      if (tg == 0) base = atomicAdd(&cnt[ql], 128);
      base = __shfl_sync(0xfu << (lane & ~3), base, lane & ~3);   // the quad agrees
      ulonglong2* d2 = reinterpret_cast<ulonglong2*>(dst + base + 2 * tg);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        ulonglong2 e;
        e.x = (pass >> (2 * j)) & 1
                  ? Sel::key(Sel::vkey(Sel::prep(acc[0][j][2 * h], kp)), rbase + 8 * j, kp)
                  : 0ull;
        e.y = (pass >> (2 * j + 1)) & 1
                  ? Sel::key(Sel::vkey(Sel::prep(acc[0][j][2 * h + 1], kp)), rbase + 8 * j + 1,
                             kp)
                  : 0ull;
        d2[4 * j] = e;
      }
    } else if (pass) {   // this lane's own, an even count
      const int n = __popc(pass);
      int pos = atomicAdd(&cnt[ql], n + (n & 1));
      if (n & 1) dst[pos + n] = 0;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          if ((pass >> (2 * j + c)) & 1)
            dst[pos++] = Sel::key(Sel::vkey(Sel::prep(acc[0][j][2 * h + c], kp)),
                                  rbase + 8 * j + c, kp);
    }
  }
  // buffers past their fold level get room for the next tile
  const int level = cap - C::TN - 8;
  if (!__syncthreads_or(t < qlim && cnt[t] > level)) return;
  for (int ql = 0; ql < qlim; ++ql) {   // uniform: counts read after the barrier
    if (cnt[ql] <= level) continue;
    fold_full<C>(buf + ((size_t)(q0 + ql) * gridDim.x + blockIdx.x) * cap, cnt[ql], k, &thr[ql],
                 &cnt[ql], scratch, t);
    __syncthreads();
  }
}

// TMA: both operands arrive by tensor copies (one thread issues them; a
// barrier per stage counts the bytes), 128-byte swizzled as wgmma reads
// them; rows and depth past the tensors' edges come back zero. Otherwise
// (rows not 16-byte aligned) every thread stages by scalar loads. Each
// 64-deep slice keeps its wgmma group in flight while the block agrees
// that the previous slice's stage is free and refills it; a tile's first
// slice overwrites the sums. grid (ranges, query tiles); buf [nq, ranges,
// cap] candidate keys, cnt [nq, ranges] their counts, bins [nq, nbins]
// (zeroed by the launcher; nbins 0: none).
template <class C, typename Sel, bool TMA>
__global__ void __launch_bounds__(C::THREADS, 1) range_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ x, int nq,
    int n_eff, int d, int k, int qb, int range_rows, KeyParams kp, int cap, int nbins,
    uint64_t* __restrict__ buf, int* __restrict__ cnt_out, uint32_t* __restrict__ bins,
    const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;
  const uint32_t bars = sbase + C::STAGES * C::STAGE_BYTES;   // [STAGES] mbarriers
  unsigned char* tail = smem_raw + (sbase - raw) + (size_t)C::STAGES * C::STAGE_BYTES + 64;
  uint64_t* thr = reinterpret_cast<uint64_t*>(tail);          // [QT]
  int* cnt = reinterpret_cast<int*>(thr + C::QT);             // [QT]
  uint32_t* gb = reinterpret_cast<uint32_t*>(cnt + C::QT);    // [QT]
  int* scratch = reinterpret_cast<int*>(gb + C::QT);          // [4]
  uint32_t* top = reinterpret_cast<uint32_t*>(scratch + 4);   // [2][4][THREADS]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wgi = warp >> 2, wm = wgi / C::WN, wn = wgi % C::WN;
  const int q0 = blockIdx.y * qb;
  const int qlim = min(qb, nq - q0);
  const int r_begin = blockIdx.x * range_rows;
  const int r_end = min(r_begin + range_rows, n_eff);
  for (int e = t; e < C::QT; e += C::THREADS) {
    thr[e] = 0;
    cnt[e] = 0;
    gb[e] = 0;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) top[i * C::THREADS + t] = 0;

  const int n_tiles = r_end > r_begin ? (r_end - r_begin + C::TN - 1) / C::TN : 0;
  const int ksteps = d > 0 ? (d + DK - 1) / DK : 1;
  const int total = n_tiles * ksteps;
  auto issue = [&](int s) {   // TMA: thread 0 only
    const uint32_t st = sbase + (s % C::STAGES) * C::STAGE_BYTES;
    const int r0 = r_begin + (s / ksteps) * C::TN, d0 = (s % ksteps) * DK;
    if (TMA) {
      const uint32_t bar = bars + 8 * (s % C::STAGES);
      mbar_expect(bar, C::STAGE_BYTES);
      tma_load(st, &tmq, d0, q0, bar);
      tma_load(st + C::QT * DK * 2, &tmx, d0, r0, bar);
    } else {
      load_stage<C::QT, C::TN, C::THREADS>(st, q, x, q0, qlim, r0, r_end, d0, d, t);
    }
  };
  if (TMA && t == 0) {
    for (int s = 0; s < C::STAGES; ++s) mbar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int s = 0; s < C::STAGES - 1 && s < total; ++s)
    if (!TMA || t == 0) issue(s);

  // a lane's rows across the range are one source of the shared bins
  const int src = (blockIdx.x * C::WN + wn) * 4 + (lane & 3);
  float acc[1][16][4];
  int step = 0;
  // one 64-deep slice: its stage landed, multiply (the tile's first slice
  // overwrites the sums), keep the group in flight; the previous slice's
  // group is done here, and after the barrier everywhere, so its stage
  // takes the next copies
  auto slice = [&](auto first) {
    const int slot = step % C::STAGES;
    if (TMA) {
      mbar_wait(bars + 8 * slot, (step / C::STAGES) & 1);
    } else {   // every thread's stores -> the async proxy wgmma reads through
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    const uint32_t st = sbase + slot * C::STAGE_BYTES;
    const uint64_t da = desc(st + wm * 64 * DK * 2);
    const uint64_t db = desc(st + (C::QT + wn * 128) * DK * 2);
    if constexpr (!decltype(first)::value) fence_operands(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    if constexpr (decltype(first)::value) wgmma_m64n128k16_first(acc, da, db);
    else wgmma_m64n128k16(acc, da, db);
#pragma unroll
    for (int kk = 1; kk < DK / 16; ++kk)   // 32 bytes along each swizzled row
      wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    __syncthreads();
    if (step + C::STAGES - 1 < total && (!TMA || t == 0)) issue(step + C::STAGES - 1);
    ++step;
  };
  for (int tile = 0; tile < n_tiles; ++tile) {
    slice(std::true_type{});
    for (int ks = 1; ks < ksteps; ++ks) slice(std::false_type{});
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc);
    append_tile<Sel, C>(acc, top, wm * 64 + (warp & 3) * 16, wn * 128,
                        r_begin + tile * C::TN, r_end, qlim, q0, k, cap, nbins, src, thr, cnt, gb,
                        scratch, buf, bins, kp, t, lane);
  }
  __syncthreads();
  for (int ql = t; ql < qlim; ql += C::THREADS)
    cnt_out[(size_t)(q0 + ql) * gridDim.x + blockIdx.x] = cnt[ql];
}

}  // namespace wg

// -- kernel 1 at k 1 for many queries (exact mode, bf16, 16-byte rows): the
// build's assignment, Q in the hundreds of thousands over 65,536 centroids.
// A 2-block cluster shares each centroid tile: block r of the pair loads
// half of it by one TMA multicast into both blocks' rings. Per block, a
// producer warpgroup (one issuing thread, registers lowered by setmaxnreg)
// keeps a 4-stage ring of 64-deep slices in flight, each stage with a full
// and an empty mbarrier; two consumer warpgroups each multiply 64 queries
// by the tile's 256 centroids (wgmma.m64n256k16, one group kept in flight)
// and release each stage to the producers of both blocks. The epilogue is
// running_max: each thread's running (max, lowest row) of its two query
// rows stays in registers across the range, and one (value, row) a query
// is written at the end.

namespace kone {

constexpr int BM = 128, BN = 256, STAGES = 4, CLUSTER = 2;
constexpr int THREADS = 384;                // a producer warpgroup, two consumer warpgroups
constexpr int HALF = BN / CLUSTER;          // centroid rows each block of the pair loads
constexpr int A_BYTES = BM * DK * 2;        // the query slice of a stage
constexpr int STAGE_BYTES = (BM + BN) * DK * 2;
constexpr int ARRIVALS = CLUSTER * 8;       // consumer warps of both blocks free a stage
// 1 KiB to align the ring, the ring, a full and an empty barrier a stage
constexpr size_t SMEM = 1024 + (size_t)STAGES * STAGE_BYTES + 16 * STAGES;

__device__ __forceinline__ uint32_t cta_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init_n(uint32_t bar, uint32_t n) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(n));
}
// arrive on the barrier at this shared offset in block `cta` of the cluster.
// The default (CTA-scope) release: a cluster-scope release fence here sat on
// the consumers' critical path every stage (the scan took 56 ms, not 25.5,
// at the build shape on an H100; tools/topk_variants.py). The stage's wgmma
// reads are complete (wait_group) before the arrive, and the producer's
// next copy into it waits on this barrier.
__device__ __forceinline__ void arrive_cluster(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 ra;\n"
      "mapa.shared::cluster.u32 ra, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [ra];\n"
      "}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}
// box {64 deep, rows} at (depth c0, row c1) into the same offset of every
// block in `mask`, each block's barrier at `bar` counting the bytes
__device__ __forceinline__ void tma_load_mc(uint32_t dst, const CUtensorMap* map, int c0, int c1,
                                            uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"((uint64_t)map), "r"(c0), "r"(c1), "r"(bar), "h"(mask)
      : "memory");
}

__device__ __forceinline__ void fence_operands(float (&d)[1][32][4]) {
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) asm volatile("" : "+f"(d[0][j][v])::"memory");
}

__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[1][32][4], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0][0]), "+f"(d[0][0][1]), "+f"(d[0][0][2]), "+f"(d[0][0][3]),
        "+f"(d[0][1][0]), "+f"(d[0][1][1]), "+f"(d[0][1][2]), "+f"(d[0][1][3]),
        "+f"(d[0][2][0]), "+f"(d[0][2][1]), "+f"(d[0][2][2]), "+f"(d[0][2][3]),
        "+f"(d[0][3][0]), "+f"(d[0][3][1]), "+f"(d[0][3][2]), "+f"(d[0][3][3]),
        "+f"(d[0][4][0]), "+f"(d[0][4][1]), "+f"(d[0][4][2]), "+f"(d[0][4][3]),
        "+f"(d[0][5][0]), "+f"(d[0][5][1]), "+f"(d[0][5][2]), "+f"(d[0][5][3]),
        "+f"(d[0][6][0]), "+f"(d[0][6][1]), "+f"(d[0][6][2]), "+f"(d[0][6][3]),
        "+f"(d[0][7][0]), "+f"(d[0][7][1]), "+f"(d[0][7][2]), "+f"(d[0][7][3]),
        "+f"(d[0][8][0]), "+f"(d[0][8][1]), "+f"(d[0][8][2]), "+f"(d[0][8][3]),
        "+f"(d[0][9][0]), "+f"(d[0][9][1]), "+f"(d[0][9][2]), "+f"(d[0][9][3]),
        "+f"(d[0][10][0]), "+f"(d[0][10][1]), "+f"(d[0][10][2]), "+f"(d[0][10][3]),
        "+f"(d[0][11][0]), "+f"(d[0][11][1]), "+f"(d[0][11][2]), "+f"(d[0][11][3]),
        "+f"(d[0][12][0]), "+f"(d[0][12][1]), "+f"(d[0][12][2]), "+f"(d[0][12][3]),
        "+f"(d[0][13][0]), "+f"(d[0][13][1]), "+f"(d[0][13][2]), "+f"(d[0][13][3]),
        "+f"(d[0][14][0]), "+f"(d[0][14][1]), "+f"(d[0][14][2]), "+f"(d[0][14][3]),
        "+f"(d[0][15][0]), "+f"(d[0][15][1]), "+f"(d[0][15][2]), "+f"(d[0][15][3]),
        "+f"(d[0][16][0]), "+f"(d[0][16][1]), "+f"(d[0][16][2]), "+f"(d[0][16][3]),
        "+f"(d[0][17][0]), "+f"(d[0][17][1]), "+f"(d[0][17][2]), "+f"(d[0][17][3]),
        "+f"(d[0][18][0]), "+f"(d[0][18][1]), "+f"(d[0][18][2]), "+f"(d[0][18][3]),
        "+f"(d[0][19][0]), "+f"(d[0][19][1]), "+f"(d[0][19][2]), "+f"(d[0][19][3]),
        "+f"(d[0][20][0]), "+f"(d[0][20][1]), "+f"(d[0][20][2]), "+f"(d[0][20][3]),
        "+f"(d[0][21][0]), "+f"(d[0][21][1]), "+f"(d[0][21][2]), "+f"(d[0][21][3]),
        "+f"(d[0][22][0]), "+f"(d[0][22][1]), "+f"(d[0][22][2]), "+f"(d[0][22][3]),
        "+f"(d[0][23][0]), "+f"(d[0][23][1]), "+f"(d[0][23][2]), "+f"(d[0][23][3]),
        "+f"(d[0][24][0]), "+f"(d[0][24][1]), "+f"(d[0][24][2]), "+f"(d[0][24][3]),
        "+f"(d[0][25][0]), "+f"(d[0][25][1]), "+f"(d[0][25][2]), "+f"(d[0][25][3]),
        "+f"(d[0][26][0]), "+f"(d[0][26][1]), "+f"(d[0][26][2]), "+f"(d[0][26][3]),
        "+f"(d[0][27][0]), "+f"(d[0][27][1]), "+f"(d[0][27][2]), "+f"(d[0][27][3]),
        "+f"(d[0][28][0]), "+f"(d[0][28][1]), "+f"(d[0][28][2]), "+f"(d[0][28][3]),
        "+f"(d[0][29][0]), "+f"(d[0][29][1]), "+f"(d[0][29][2]), "+f"(d[0][29][3]),
        "+f"(d[0][30][0]), "+f"(d[0][30][1]), "+f"(d[0][30][2]), "+f"(d[0][30][3]),
        "+f"(d[0][31][0]), "+f"(d[0][31][1]), "+f"(d[0][31][2]), "+f"(d[0][31][3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// grid (query tiles rounded up to the cluster, ranges); cand null when the
// range is the whole corpus
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1) range_kernel(
    int nq, int n_eff, int d, int range_rows, ExactSel::E* __restrict__ cand,
    float* __restrict__ out_v, int* __restrict__ out_i, const __grid_constant__ CUtensorMap tmq,
    const __grid_constant__ CUtensorMap tmx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;
  const uint32_t full = sbase + STAGES * STAGE_BYTES, empty = full + 8 * STAGES;
  const int t = threadIdx.x, wgi = t >> 7;
  const int q0 = blockIdx.x * BM;
  const int r_begin = blockIdx.y * range_rows;
  const int r_end = min(r_begin + range_rows, n_eff);
  const int n_tiles = r_end > r_begin ? (r_end - r_begin + BN - 1) / BN : 0;
  const int ksteps = d > 0 ? (d + DK - 1) / DK : 1;
  const int total = n_tiles * ksteps;
  if (t == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init_n(full + 8 * s, 1);
      mbar_init_n(empty + 8 * s, ARRIVALS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();   // both blocks' barriers exist before any copy or remote arrive

  if (wgi == 0) {   // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (t == 0) {
      const uint32_t rank = cta_rank();
      for (int it = 0; it < total; ++it) {
        const int s = it % STAGES;
        wg::mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);   // round 0 passes
        const uint32_t st = sbase + s * STAGE_BYTES, bar = full + 8 * s;
        const int r0 = r_begin + (it / ksteps) * BN, d0 = (it % ksteps) * DK;
        wg::mbar_expect(bar, STAGE_BYTES);   // own queries + both halves of the tile
        wg::tma_load(st, &tmq, d0, q0, bar);
        tma_load_mc(st + A_BYTES + rank * HALF * DK * 2, &tmx, d0, r0 + (int)rank * HALF, bar,
                    (uint16_t)((1u << CLUSTER) - 1));
      }
    }
    cluster_sync();   // neither block exits while the other may still arrive on it
    return;
  }

  // ptxas gives the whole kernel 168 registers (the launch bound), but
  // without this raise it serializes the wgmma groups (C7518: a dependence
  // on a compiler-inserted wait in a divergent path), and the scan took
  // 30.5 ms, not 25, at the build shape on an H100
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int cw = wgi - 1, warp = (t >> 5) & 3, lane = t & 31, g = lane >> 2, tg = lane & 3;
  // a stage is free once every consumer warp of both blocks has read it
  auto release = [&](int s) {
    if (lane == 0) {
      for (uint32_t c = 0; c < CLUSTER; ++c) arrive_cluster(empty + 8 * s, c);
    }
  };
  float acc[1][32][4];
#pragma unroll
  for (int j = 0; j < 32; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[0][j][v] = 0.f;
  float rv[1][2] = {{-INFINITY, -INFINITY}};
  int ri[1][2] = {{IDX_NONE, IDX_NONE}};
  for (int it = 0; it < total; ++it) {
    const int s = it % STAGES, ks = it % ksteps;
    wg::mbar_wait(full + 8 * s, (it / STAGES) & 1);
    const uint32_t st = sbase + s * STAGE_BYTES;
    const uint64_t da = wg::desc(st + cw * 64 * DK * 2), db = wg::desc(st + A_BYTES);
    fence_operands(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)   // a tile's first slice overwrites the sums
      wgmma_m64n256k16(acc, da + 2 * kk, db + 2 * kk, ks > 0 || kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    if (ks != ksteps - 1) {   // keep this slice's group in flight, free the last one's stage
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      if (ks > 0) release((it - 1) % STAGES);
      continue;
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc);
    if (ks > 0) release((it - 1) % STAGES);
    release(s);
    running_max<1, 32>(acc, rv, ri, r_begin + (it / ksteps) * BN + 2 * tg, r_end);
  }
  quad_max<1>(rv, ri);
  if (tg == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gq = q0 + cw * 64 + warp * 16 + g + 8 * h;
      if (gq < nq) put_k1(rv[0][h], ri[0][h], gq, cand, gridDim.y, blockIdx.y, out_v, out_i);
    }
  }
  cluster_sync();   // neither block exits while the other may still arrive on it
}

}  // namespace kone

}  // namespace tc

// ---------------------------------------------------------------------------
// f32 operands, register-blocked (true f32: no tensor cores, no TF32). A
// block multiplies QT queries (64 or 128) by a tile of 128 corpus rows; each
// warp holds 64 queries x TN / WN rows, each thread 8 queries x 2 NT rows of
// sums in the fragment layout select_tile reads (query qoff + 16i + g + 8h,
// row roff + 8j + 2tg + c). Both operands are staged 32 deep (128-byte rows)
// into a 4-stage ring by TMA tensor copies, one thread issuing them and an
// mbarrier a stage counting the bytes, 128-byte swizzled: the 8 (or 4) rows
// a warp reads at once hold their float4 fragments in distinct banks. Each
// thread sums in depth order. One __syncthreads a step frees the stage the
// next copies overwrite. Selection from the registers: select_tile's lists
// for k > 1, running_max at k 1 (exact mode). Rows that are not 16-byte
// aligned are staged by scalar loads into the same layout.

namespace simt {

constexpr int DK = 32;        // depth per stage: 128-byte rows
constexpr int STAGES = 4;
constexpr int TN = 128;       // corpus rows per tile
constexpr int CB = 16;        // candidate slots per query

// float offset of float4 chunk c of staged row r (TMA's 128-byte swizzle)
__device__ __forceinline__ int swz(int r, int c) { return r * DK + ((c ^ (r & 7)) << 2); }

template <int QT, int WN>
struct Cfg {
  static constexpr int NT = TN / WN / 8;              // 8-row fragment columns a thread holds
  static constexpr int THREADS = 32 * (QT / 64) * WN;
  static constexpr int WARPS = THREADS / 32;
  static constexpr int STAGE_BYTES = (QT + TN) * DK * 4;
  // 1 KiB to align the ring, the ring, a barrier a stage, then per query a
  // list of k entries, CB candidate slots and a count (at k 1 the lists
  // hold the warps' partial maxima instead)
  static constexpr size_t smem(int k) {
    return 1024 + (size_t)STAGES * STAGE_BYTES + 8 * STAGES + 8 * (size_t)QT * (k + CB) +
           4 * (size_t)QT;
  }
  static_assert(NT * 8 * WN == TN && QT % 64 == 0 && WN <= CB + 1, "warp layout");
};

// Stage depth slice [d0, d0 + DK) of queries [q0, q0 + QT) (staged rows
// 0..QT-1) and corpus rows [r0, r0 + TN) (rows QT..) by scalar loads, zero
// past nq, r_end and d: the staging of rows TMA cannot copy.
template <int QT, int THREADS>
__device__ __forceinline__ void stage_scalar(float* st, const float* __restrict__ q,
                                             const float* __restrict__ x, int q0, int nq,
                                             int r0, int r_end, int d0, int d, int t) {
  constexpr int CH = DK / 4;   // 16-byte chunks per staged row
  for (int e = t; e < (QT + TN) * CH; e += THREADS) {
    const int row = e / CH, c = e % CH, gd = d0 + 4 * c;
    const float* src;
    bool ok;
    if (row < QT) {
      ok = q0 + row < nq;
      src = q + (size_t)(q0 + row) * d + gd;
    } else {
      const int gr = r0 + row - QT;
      ok = gr < r_end;
      src = x + (size_t)gr * d + gd;
    }
    float4 v;
    v.x = ok && gd < d ? src[0] : 0.f;
    v.y = ok && gd + 1 < d ? src[1] : 0.f;
    v.z = ok && gd + 2 < d ? src[2] : 0.f;
    v.w = ok && gd + 3 < d ? src[3] : 0.f;
    *reinterpret_cast<float4*>(st + swz(row, c)) = v;
  }
}

// acc += the staged slice's products, depth in order
template <int QT, int NT>
__device__ __forceinline__ void multiply(const float* st, float (&acc)[4][NT][4], int qoff,
                                         int roff, int g, int tg) {
  // a thread's query rows all swizzle by g, its corpus rows by (2tg + c) & 7
  const float* as = st + (qoff + g) * DK;
  const float* bs = st + (QT + roff + 2 * tg) * DK;
#pragma unroll
  for (int kq = 0; kq < DK / 4; ++kq) {
    float4 a[4][2], b[NT][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[i][h] = *reinterpret_cast<const float4*>(as + (16 * i + 8 * h) * DK + ((kq ^ g) << 2));
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int cb = (kq ^ ((2 * tg + c) & 7)) << 2;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        b[j][c] = *reinterpret_cast<const float4*>(bs + (8 * j + c) * DK + cb);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& s = acc[i][j][2 * h + c];
            s = fmaf(a[i][h].x, b[j][c].x, s);
            s = fmaf(a[i][h].y, b[j][c].y, s);
            s = fmaf(a[i][h].z, b[j][c].z, s);
            s = fmaf(a[i][h].w, b[j][c].w, s);
          }
  }
}

// grid (ranges, query tiles); cand null when exact mode at k 1 has one
// range (no second pass); tmq/tmx: f32 boxes {32 deep, QT or TN rows} (VEC)
template <typename Sel, int QT, int WN, bool VEC>
__global__ void __launch_bounds__(Cfg<QT, WN>::THREADS, 1) range_kernel(
    const float* __restrict__ q, const float* __restrict__ x, int nq, int n_eff, int d, int k,
    int range_rows, KeyParams kp, typename Sel::E* __restrict__ cand, float* __restrict__ out_v,
    int* __restrict__ out_i, const __grid_constant__ CUtensorMap tmq,
    const __grid_constant__ CUtensorMap tmx) {
  using C = Cfg<QT, WN>;
  using E = typename Sel::E;
  constexpr int NT = C::NT;
  constexpr bool EXACT = std::is_same<Sel, ExactSel>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;
  unsigned char* ring_p = smem_raw + (sbase - raw);
  float* ring = reinterpret_cast<float*>(ring_p);
  const uint32_t bars = sbase + STAGES * C::STAGE_BYTES;
  E* lst = reinterpret_cast<E*>(ring_p + STAGES * C::STAGE_BYTES + 8 * STAGES);   // [QT][k]
  E* cbuf = lst + (size_t)QT * k;                                                  // [QT][CB]
  int* cnt = reinterpret_cast<int*>(cbuf + (size_t)QT * CB);                       // [QT]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, g = lane >> 2, tg = lane & 3;
  const int qoff = (warp / WN) * 64, roff = (warp % WN) * (TN / WN);
  const int q0 = blockIdx.y * QT, qlim = min(QT, nq - q0);
  const int r_begin = blockIdx.x * range_rows;
  const int r_end = min(r_begin + range_rows, n_eff);
  const bool k1 = EXACT && k == 1;
  if (!k1) tc::init_lists<Sel>(lst, cnt, QT, k, t, C::THREADS);
  if (VEC && t == 0) {
    for (int s = 0; s < STAGES; ++s) tc::wg::mbar_init(bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int n_tiles = r_end > r_begin ? (r_end - r_begin + TN - 1) / TN : 0;
  const int ksteps = d > 0 ? (d + DK - 1) / DK : 1;
  const int total = n_tiles * ksteps;
  auto issue = [&](int s) {   // VEC: thread 0 only
    const int r0 = r_begin + (s / ksteps) * TN, d0 = (s % ksteps) * DK;
    const int slot = s % STAGES;
    if (VEC) {
      const uint32_t st = sbase + slot * C::STAGE_BYTES, bar = bars + 8 * slot;
      tc::wg::mbar_expect(bar, C::STAGE_BYTES);
      tc::wg::tma_load(st, &tmq, d0, q0, bar);
      tc::wg::tma_load(st + QT * DK * 4, &tmx, d0, r0, bar);
    } else {
      stage_scalar<QT, C::THREADS>(ring + slot * (C::STAGE_BYTES / 4), q, x, q0, nq, r0, r_end,
                                   d0, d, t);
    }
  };
  for (int s = 0; s < STAGES - 1 && s < total; ++s)
    if (!VEC || t == 0) issue(s);
  float acc[4][NT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
  float rv[4][2];
  int ri[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rv[i][h] = -INFINITY;
      ri[i][h] = IDX_NONE;
    }
  for (int step = 0; step < total; ++step) {
    if (VEC) tc::wg::mbar_wait(bars + 8 * (step % STAGES), (step / STAGES) & 1);
    // slice `step` landed, and every thread is done with the stage the
    // next copies overwrite
    __syncthreads();
    if (step + STAGES - 1 < total && (!VEC || t == 0)) issue(step + STAGES - 1);
    multiply<QT, NT>(ring + (step % STAGES) * (C::STAGE_BYTES / 4), acc, qoff, roff, g, tg);
    if (step % ksteps != ksteps - 1) continue;
    const int r0 = r_begin + (step / ksteps) * TN;
    if (k1) {
      tc::running_max<4, NT>(acc, rv, ri, r0 + roff + 2 * tg, r_end);
    } else {
      tc::select_tile<Sel, 4, NT, C::WARPS, CB>(acc, qoff, roff, r0, r_end, qlim, k, lst, cbuf,
                                                cnt, kp, warp, lane);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
  }
  if (!k1) {
    tc::finish<Sel, C::WARPS, CB>(lst, cbuf, cnt, q0, qlim, k, t, C::THREADS, kp, cand);
    return;
  }
  // k 1: the quad's maximum, then the WN warps that share the queries
  tc::quad_max<4>(rv, ri);
  ExactSel::E* red = reinterpret_cast<ExactSel::E*>(lst);   // [QT][WN]
  if (tg == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        red[(qoff + 16 * i + g + 8 * h) * WN + warp % WN] = {rv[i][h], ri[i][h]};
  }
  __syncthreads();
  for (int ql = t; ql < qlim; ql += C::THREADS) {
    ExactSel::E b = red[ql * WN];
    for (int w = 1; w < WN; ++w)
      if (ExactSel::better(red[ql * WN + w], b)) b = red[ql * WN + w];
    tc::put_k1(b.v, b.i, q0 + ql, reinterpret_cast<ExactSel::E*>(cand), gridDim.x, blockIdx.x,
               out_v, out_i);
  }
}

}  // namespace simt

// One block per query: k rounds of a block-wide argmax over the heads of
// the sorted per-range lists.
template <typename Sel>
__global__ void __launch_bounds__(MERGE_THREADS) topk_merge_kernel(
    const typename Sel::E* __restrict__ cand, int n_ranges, int k, KeyParams kp,
    float* __restrict__ out_v, int* __restrict__ out_i) {
  using E = typename Sel::E;
  extern __shared__ int ptr[];  // [n_ranges] head of each range list
  __shared__ E we[MERGE_THREADS / 32];
  __shared__ int wr[MERGE_THREADS / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t base = (size_t)blockIdx.x * n_ranges * k;
  for (int r = t; r < n_ranges; r += MERGE_THREADS) ptr[r] = 0;
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    E be = Sel::none();
    int br = -1;
    for (int r = t; r < n_ranges; r += MERGE_THREADS) {
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
      for (int w = 1; w < MERGE_THREADS / 32; ++w)
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

// The wgmma scan's second pass, one block per query: the k best of the
// candidates every range left in device memory (zero keys are empty
// slots). The bins give the final bound (a proven lower bound on the k-th
// best score, see append_tile), and the candidates at or above it are
// gathered into shared memory. A few (at most SEL_THREADS) are ranked at
// once: each thread counts the keys above its own and writes it at that
// place when it is below k. More: their k-th largest key is found by a
// radix select (8-bit digits, most significant first), and the k keys at
// or above it are ranked the same way, or sorted by a bitonic network
// when k is above SEL_THREADS. When more than SEL_SMAX candidates reach
// the bound (many equal scores), the radix select reads them from device
// memory instead.
constexpr int SEL_THREADS = 512;
constexpr int SEL_SMAX = 4096;   // candidates held in shared memory

template <typename Sel>
__device__ __forceinline__ void put_key(uint64_t kk, const KeyParams& kp, float* v, int* i) {
  Sel::out(kk ? Sel::from_key(kk) : Sel::none(), kp, v, i);
}

// Write keys[0, n) (unique; n at most SEL_THREADS) to out[0, k) in
// descending order, empty slots past n: thread i ranks key i by counting.
template <typename Sel>
__device__ __forceinline__ void rank_out(const uint64_t* keys, int n, int k, const KeyParams& kp,
                                         float* out_v, int* out_i, int t) {
  if (t < n) {
    const uint64_t mine = keys[t];
    int r = 0;
    for (int j = 0; j < n; ++j) r += keys[j] > mine;
    if (r < k) put_key<Sel>(mine, kp, out_v + r, out_i + r);
  }
  for (int j = n + t; j < k; j += SEL_THREADS) put_key<Sel>(0, kp, out_v + j, out_i + j);
}

template <typename Sel>
__global__ void __launch_bounds__(SEL_THREADS) topk_select_kernel(
    const uint64_t* __restrict__ buf, const int* __restrict__ cnt,
    const uint32_t* __restrict__ bins, int n_ranges, int cap, int k, int kp2, int nbins,
    KeyParams kp, float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char sel_raw[];
  uint64_t* s = reinterpret_cast<uint64_t*>(sel_raw);   // [SEL_SMAX] candidates
  uint64_t* w = s + SEL_SMAX;                            // [kp2] the k best
  int* pre = reinterpret_cast<int*>(w + kp2);            // [n_ranges + 1] offsets
  __shared__ int hist[256], wsum[SEL_THREADS / 32];
  __shared__ int s_n, s_kk;
  __shared__ uint32_t s_v;
  __shared__ uint64_t s_prefix;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t qr = (size_t)blockIdx.x * n_ranges;
  float* ov = out_v + (size_t)blockIdx.x * k;
  int* oi = out_i + (size_t)blockIdx.x * k;
  if (warp == 0) {   // the final bound: the least bin
    uint32_t v = 0xffffffffu;
    for (int b = lane; b < nbins; b += 32) v = min(v, bins[(size_t)blockIdx.x * nbins + b]);
#pragma unroll
    for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(FULL, v, o));
    if (lane == 0) s_v = nbins > 0 ? v : 0u;
  }
  // the ranges' counts -> offsets (n_ranges <= SEL_THREADS): a scan in
  // each warp, then over the warps' sums
  int c = t < n_ranges ? cnt[qr + t] : 0, inc = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) wsum[warp] = inc;
  if (t == 0) s_n = 0;
  __syncthreads();
  int before = 0;
  for (int i = 0; i < warp; ++i) before += wsum[i];
  if (t < n_ranges) pre[t + 1] = before + inc;
  if (t == 0) pre[0] = 0;
  __syncthreads();
  const int total = pre[n_ranges];
  const uint32_t bound = s_v;
  // candidate e of the query: range r's entry e - pre[r]
  auto entry = [&](int e) {
    int lo = 0, hi = n_ranges;   // pre[lo] <= e < pre[hi]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (pre[mid] <= e) lo = mid;
      else hi = mid;
    }
    return buf[(qr + lo) * cap + (e - pre[lo])];
  };
  constexpr int UNROLL = 4;   // loads in flight a thread
  for (int e0 = t; e0 < total; e0 += UNROLL * SEL_THREADS) {
    uint64_t kk[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int e = e0 + u * SEL_THREADS;
      kk[u] = e < total ? entry(e) : 0ull;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (kk[u] != 0 && (uint32_t)(kk[u] >> 32) >= bound) {   // zero: an empty slot
        const int p = atomicAdd(&s_n, 1);
        if (p < SEL_SMAX) s[p] = kk[u];
      }
  }
  __syncthreads();
  const int n = s_n;
  if (n <= SEL_THREADS) {
    rank_out<Sel>(s, n, k, kp, ov, oi, t);
    return;
  }
  const bool held = n <= SEL_SMAX;
  __syncthreads();   // n read everywhere before s_n is reused
  // every candidate at or above the bound, from shared or device memory
  auto visit = [&](auto&& f) {
    if (held) {
      for (int i = t; i < n; i += SEL_THREADS) f(s[i]);
    } else {
      for (int e = t; e < total; e += SEL_THREADS) {
        const uint64_t kk = entry(e);
        if (kk != 0 && (uint32_t)(kk >> 32) >= bound) f(kk);
      }
    }
  };
  uint64_t th = 0;   // the k-th largest key; 0 (below every key) when n <= k
  if (n > k) {
    int rank = k;   // th is the rank-th largest key matching the prefix
    for (int shift = 56; shift >= 0; shift -= 8) {
      for (int i = t; i < 256; i += SEL_THREADS) hist[i] = 0;
      __syncthreads();
      const uint64_t hm = shift == 56 ? 0ull : ~0ull << (shift + 8);
      visit([&](uint64_t kk) {
        if ((kk & hm) == th) atomicAdd(&hist[(kk >> shift) & 255], 1);
      });
      __syncthreads();
      if (warp == 0) {   // the digit holding the rank-th largest
        int h[8], sum = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          h[i] = hist[lane * 8 + i];
          sum += h[i];
        }
        int suf = sum;   // counts in lanes >= this one
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_down_sync(FULL, suf, o);
          if (lane + o < 32) suf += y;
        }
        const unsigned ge = __ballot_sync(FULL, suf >= rank);
        if (lane == 31 - __clz(ge)) {
          int above = suf - sum;
          for (int i = 7; i >= 0; --i) {
            if (above + h[i] >= rank) {
              s_prefix = th | ((uint64_t)(lane * 8 + i) << shift);
              s_kk = rank - above;
              break;
            }
            above += h[i];
          }
        }
      }
      __syncthreads();
      th = s_prefix;
      rank = s_kk;
    }
  }
  for (int i = t; i < kp2; i += SEL_THREADS) w[i] = 0;
  if (t == 0) s_n = 0;
  __syncthreads();
  visit([&](uint64_t kk) {
    if (kk >= th) w[atomicAdd(&s_n, 1)] = kk;   // keys unique: min(n, k) of them
  });
  __syncthreads();
  if (k <= SEL_THREADS) {
    rank_out<Sel>(w, min(n, k), k, kp, ov, oi, t);
    return;
  }
  for (int size = 2; size <= kp2; size <<= 1)   // bitonic sort, descending
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = t; i < kp2 / 2; i += SEL_THREADS) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const uint64_t a = w[lo], b = w[hi];
        if ((a < b) == ((lo & size) == 0)) {
          w[lo] = b;
          w[hi] = a;
        }
      }
      __syncthreads();
    }
  for (int j = t; j < k; j += SEL_THREADS) put_key<Sel>(w[j], kp, ov + j, oi + j);
}

// Pass-1 configurations, numbered as the wrapper's plan names them (0, the
// 32-query FMA scan, was replaced by SIMT64 and SIMT128).
enum { FMA8 = 1, TC_MID = 2, TC_LARGE = 3, SIMT64 = 4, SIMT128 = 5, TC_K1 = 6 };
// warps along the rows of the register-blocked scan's tile
constexpr int SIMT64_WN = 8, SIMT128_WN = 4;

size_t smem_bytes(int cfg, int qb, int k) {
  switch (cfg) {
    case FMA8: return f32scan::Tile<8, 128>::smem(k);
    case TC_MID: return tc::wg::Mid::SMEM;
    case TC_LARGE: return tc::wg::Large::SMEM;
    case SIMT64: return simt::Cfg<64, SIMT64_WN>::smem(k);
    case SIMT128: return simt::Cfg<128, SIMT128_WN>::smem(k);
    case TC_K1: return tc::kone::SMEM;
  }
  return 0;
}

template <typename Sel, int QT, int TN>
cudaError_t launch_fma(const void* q, const void* x, int nq, int n_eff, int d, int k,
                       int n_ranges, int range_rows, KeyParams kp, typename Sel::E* cand,
                       cudaStream_t st) {
  const size_t smem = f32scan::Tile<QT, TN>::smem(k);
  auto kern = f32scan::range_kernel<Sel, QT, TN>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(n_ranges, (nq + QT - 1) / QT), f32scan::THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(x), nq, n_eff, d, k,
      range_rows, kp, cand);
  return cudaGetLastError();
}

using WgKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, int, int, int, int, int,
                          int, KeyParams, int, int, uint64_t*, int*, uint32_t*, const CUtensorMap,
                          const CUtensorMap);

// cuTensorMapEncodeTiled from the driver, found through the runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a row-major [rows, d] tensor (bf16, or f32 with f32 set) read in boxes of
// {128 bytes deep, box_rows}, 128-byte swizzled, zero past its edges
bool tensor_map(CUtensorMap* m, const void* base, int rows, int d, int box_rows,
                bool f32 = false) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const int size = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)(rows > 0 ? rows : 1)};
  const cuuint64_t strides[1] = {(cuuint64_t)d * size};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / size), (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(m, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The wgmma scan (pass 1, candidates into buf/cnt, bins zeroed first) and
// its select pass
template <class C, typename Sel>
cudaError_t launch_wg(int vec, const void* q, const void* x, int nq, int n_eff, int d, int k,
                      int qb, int n_ranges, int range_rows, KeyParams kp, int cap, int nbins,
                      uint64_t* buf, int* cnt, uint32_t* bins, void* out_v, void* out_i,
                      cudaStream_t st) {
  CUtensorMap tmq{}, tmx{};
  if (vec && !(tensor_map(&tmq, q, nq, d, C::QT) && tensor_map(&tmx, x, n_eff, d, C::TN)))
    return cudaErrorInvalidValue;
  if (cap < k + C::TN + 8 || cap > C::FOLD_PER_THREAD * C::THREADS || n_ranges > SEL_THREADS)
    return cudaErrorInvalidValue;
  cudaError_t e;
  if (nbins > 0 && (e = cudaMemsetAsync(bins, 0, sizeof(uint32_t) * (size_t)nq * nbins, st)) !=
                       cudaSuccess)
    return e;
  const WgKernel kern = vec ? tc::wg::range_kernel<C, Sel, true>
                            : tc::wg::range_kernel<C, Sel, false>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (e != cudaSuccess) return e;
  kern<<<dim3(n_ranges, (nq + qb - 1) / qb), C::THREADS, C::SMEM, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(x), nq, n_eff,
      d, k, qb, range_rows, kp, cap, nbins, buf, cnt, bins, tmq, tmx);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  int kp2 = 1;
  while (kp2 < k) kp2 <<= 1;
  const size_t smem2 = 8 * ((size_t)SEL_SMAX + kp2) + 4 * ((size_t)n_ranges + 1);
  e = cudaFuncSetAttribute(topk_select_kernel<Sel>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem2);
  if (e != cudaSuccess) return e;
  topk_select_kernel<Sel><<<nq, SEL_THREADS, smem2, st>>>(
      buf, cnt, bins, n_ranges, cap, k, kp2, nbins, kp, static_cast<float*>(out_v),
      static_cast<int*>(out_i));
  return cudaGetLastError();
}

template <typename Sel, int QT, int WN>
cudaError_t launch_simt(int vec, const void* q, const void* x, int nq, int n_eff, int d, int k,
                        int n_ranges, int range_rows, KeyParams kp, typename Sel::E* cand,
                        void* out_v, void* out_i, cudaStream_t st) {
  using C = simt::Cfg<QT, WN>;
  CUtensorMap tmq{}, tmx{};
  if (vec && !(tensor_map(&tmq, q, nq, d, QT, true) &&
               tensor_map(&tmx, x, n_eff, d, simt::TN, true)))
    return cudaErrorInvalidValue;
  auto kern = vec ? simt::range_kernel<Sel, QT, WN, true> : simt::range_kernel<Sel, QT, WN, false>;
  const size_t smem = C::smem(k);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(n_ranges, (nq + QT - 1) / QT), C::THREADS, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(x), nq, n_eff, d, k, range_rows,
      kp, cand, static_cast<float*>(out_v), static_cast<int*>(out_i), tmq, tmx);
  return cudaGetLastError();
}

cudaError_t launch_kone(const void* q, const void* x, int nq, int n_eff, int d, int n_ranges,
                        int range_rows, ExactSel::E* cand, void* out_v, void* out_i,
                        cudaStream_t st) {
  namespace K = tc::kone;
  CUtensorMap tmq{}, tmx{};
  if (!(tensor_map(&tmq, q, nq, d, K::BM) && tensor_map(&tmx, x, n_eff, d, K::HALF)))
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(K::range_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)K::SMEM);
  if (e != cudaSuccess) return e;
  const int tiles = (nq + K::BM - 1) / K::BM;
  const int grid_x = (tiles + K::CLUSTER - 1) / K::CLUSTER * K::CLUSTER;   // whole clusters
  K::range_kernel<<<dim3(grid_x, n_ranges), K::THREADS, K::SMEM, st>>>(
      nq, n_eff, d, range_rows, cand, static_cast<float*>(out_v), static_cast<int*>(out_i), tmq,
      tmx);
  return cudaGetLastError();
}

template <typename Sel>
int launch(const void* q, const void* x, int cfg, int vec, int nq, int n_eff, int d, int k,
           int qb, int n_ranges, int range_rows, KeyParams kp, int cap, int nbins, void* cand_p,
           void* cnt, void* bins, void* out_v, void* out_i, cudaStream_t st) {
  using E = typename Sel::E;
  E* cand = static_cast<E*>(cand_p);
  cudaError_t e;
  // exact mode at k 1 over one range: the register-blocked and k-1 scans
  // write the outputs themselves
  const bool direct = std::is_same<Sel, ExactSel>::value && k == 1 && n_ranges == 1 &&
                      (cfg == SIMT64 || cfg == SIMT128 || cfg == TC_K1);
  E* first = direct ? nullptr : cand;
  switch (cfg) {
    case FMA8:
      e = launch_fma<Sel, 8, 128>(q, x, nq, n_eff, d, k, n_ranges, range_rows, kp, cand, st);
      break;
    case TC_MID:   // the wgmma scan runs its own select pass
      return (int)launch_wg<tc::wg::Mid, Sel>(
          vec, q, x, nq, n_eff, d, k, qb, n_ranges, range_rows, kp, cap, nbins,
          static_cast<uint64_t*>(cand_p), static_cast<int*>(cnt), static_cast<uint32_t*>(bins),
          out_v, out_i, st);
    case TC_LARGE:
      return (int)launch_wg<tc::wg::Large, Sel>(
          vec, q, x, nq, n_eff, d, k, qb, n_ranges, range_rows, kp, cap, nbins,
          static_cast<uint64_t*>(cand_p), static_cast<int*>(cnt), static_cast<uint32_t*>(bins),
          out_v, out_i, st);
    case SIMT64:
      e = launch_simt<Sel, 64, SIMT64_WN>(vec, q, x, nq, n_eff, d, k, n_ranges, range_rows, kp,
                                          first, out_v, out_i, st);
      break;
    case SIMT128:
      e = launch_simt<Sel, 128, SIMT128_WN>(vec, q, x, nq, n_eff, d, k, n_ranges, range_rows,
                                            kp, first, out_v, out_i, st);
      break;
    case TC_K1:   // exact mode, k 1, 16-byte rows only
      if (!std::is_same<Sel, ExactSel>::value || k != 1 || !vec) return (int)cudaErrorInvalidValue;
      e = launch_kone(q, x, nq, n_eff, d, n_ranges, range_rows,
                      reinterpret_cast<ExactSel::E*>(first), out_v, out_i, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
  if (direct) return (int)cudaSuccess;
  const size_t smem2 = sizeof(int) * (size_t)n_ranges;
  e = cudaFuncSetAttribute(topk_merge_kernel<Sel>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (e != cudaSuccess) return (int)e;
  topk_merge_kernel<Sel><<<nq, MERGE_THREADS, smem2, st>>>(cand, n_ranges, k, kp,
                                                           static_cast<float*>(out_v),
                                                           static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory pass 1 needs in configuration cfg (FMA8, SIMT* for f32
// operands, TC_* for bf16) at this k (qb is not read: TC_* hold per query
// 16 bytes, whatever k and however many queries they serve).
size_t topk_smem_bytes(int cfg, int qb, int k) { return smem_bytes(cfg, qb, k); }

// q [nq, d], x [>= n_eff, d]: f32 for cfg FMA8/SIMT*, bf16 for cfg TC_*;
// only rows < n_eff are candidates. qb: queries per block (TC_MID and
// TC_LARGE; the others take their tile's). vec = 1: rows and bases 16-byte
// aligned, so TC_* stage by TMA and SIMT* by cp.async; TC_K1 needs it.
// fast = 1 selects fast mode with lane_bits, chunk_log2 and n_chunks
// (ignored in exact mode; TC_K1 refuses it). cand: 8-byte scratch, [nq,
// n_ranges, k] for FMA8/SIMT*/TC_K1 and [nq, n_ranges, cap] candidate keys
// for TC_* (cap > k: slots per query and range), whose counts go to cnt
// [nq, n_ranges] (int32) and whose shared bins are bins [nq, nbins]
// (uint32, zeroed here; nbins 0: none); out_v/out_i: [nq, k]. Returns
// cudaGetLastError().
int topk_launch(const void* q, const void* x, int cfg, int vec, int nq, int n_eff, int d,
                int k, int qb, int n_ranges, int range_rows, int fast, int lane_bits,
                int chunk_log2, int n_chunks, int cap, int nbins, void* cand, void* cnt,
                void* bins, void* out_v, void* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const KeyParams kp{lane_bits, chunk_log2, n_chunks};
  if (fast)
    return launch<FastSel>(q, x, cfg, vec, nq, n_eff, d, k, qb, n_ranges, range_rows, kp, cap,
                           nbins, cand, cnt, bins, out_v, out_i, st);
  return launch<ExactSel>(q, x, cfg, vec, nq, n_eff, d, k, qb, n_ranges, range_rows, kp, cap,
                          nbins, cand, cnt, bins, out_v, out_i, st);
}

}  // extern "C"
