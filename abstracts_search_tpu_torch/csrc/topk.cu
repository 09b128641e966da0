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
//   pass 1: block (range, query tile) scores its range a tile at a time
//     and keeps a sorted top-k list per query in shared memory; each range
//     writes its lists to a [Q, ranges, k] scratch.
//   pass 2 (topk_merge_kernel): one block per query merges the sorted
//     range lists head by head (k rounds of a block-wide argmax over the
//     heads) under the same order.
//
// What bounds it: the corpus read, each byte once. At flat search's
// 2,097,152 x 1024 bf16 (4.29 GB) that is 1.28 ms at 3.35 TB/s; at the
// probe's 65,536 x 1024 bf16 centroids (128 MiB) 40 us. At Q 128 that is
// 128 flop per corpus byte, so reaching the bytes bound takes ~430
// TFLOP/s of bf16: tensor cores only.
//
// Pass 1 for bf16 operands, against each limit of the f32-FMA scan it
// replaced (f32 widening, element-wise staging, a 32-query tile, ranges
// set by FMA occupancy):
//   - tile product on tensor cores. tc::wg::range_kernel: four warpgroups
//     of wgmma.m64n128k16 (bf16 -> f32), both operands read straight from
//     shared memory. x [N, D] row-major is already the K-major B operand.
//     bf16 products are exact in f32; only the order of the sum differs
//     from the plain version.
//   - one corpus read for Q <= 256: a block holds 256 queries (x 128
//     corpus rows per tile) or 128 (x 256), padded rows zero, so the
//     corpus streams once per query tile; Q above 256 loops over tiles
//     (grid y). A k whose lists do not fit 128 queries' shared memory
//     gives the 128-query tile fewer queries per block (qb): the tile
//     still multiplies 128 query rows, and those past the block's qb
//     are masked. So does a call with few queries.
//   - staging without per-thread copies: one thread issues TMA tensor
//     copies of 64-deep slices into a 3-stage ring (an mbarrier per stage
//     counts the bytes), 128-byte swizzled as wgmma reads them; rows and
//     depth past the tensors' edges arrive as zeros. The next slices load
//     while the current one multiplies, across tile boundaries. Rows that
//     are not 16-byte aligned (d % 8 != 0) are staged by scalar loads
//     into the same swizzle instead.
//   - selection from registers: each score is masked (rows >= r_end,
//     padded queries) and compared with its query's current k-th entry
//     where the accumulator holds it; only scores that pass go to a 16-slot
//     candidate buffer per query in shared memory. On a range's
//     first tile, when the lists are empty, the four lanes that share a
//     query bound its 16th-best score from below first. A full buffer is
//     folded into the sorted list by ranks (two queries per warp for k <=
//     16), and the scores that found it full retry against the raised
//     threshold. After the first tiles almost nothing passes.
//   - a grid sized to the card: one block per SM, and the wrapper's plan
//     sets the ranges so that the grid is one wave.
// f32 operands keep the f32-FMA scan (f32scan::range_kernel): TF32 would
// break the HIGHEST-precision contract of the f32 path, so the route is
// chosen by dtype, not as a fallback. No --use_fast_math: decoded
// fast-mode values may be denormal.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

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
};

static_assert(sizeof(ExactSel::E) == 8 && sizeof(FastSel::E) == 8, "8-byte entries");

// ---------------------------------------------------------------------------
// f32 operands: f32 FMAs from shared memory, insertion into sorted lists.

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

namespace wg {

template <int WM_, int WN_, int STAGES_, int CB_>
struct Cfg {
  static constexpr int WM = WM_, WN = WN_, STAGES = STAGES_, CB = CB_;
  static constexpr int THREADS = 128 * WM * WN, WARPS = THREADS / 32;
  static constexpr int QT = 64 * WM;    // query rows per tile (a block serves qb <= QT)
  static constexpr int TN = 128 * WN;   // corpus rows per tile
  static constexpr int STAGE_BYTES = (QT + TN) * DK * 2;
  static_assert(STAGE_BYTES % 1024 == 0, "swizzle atoms 1024-byte aligned");
  // 1 KiB to align the stages, the stages, 64 bytes of stage barriers,
  // then per query a sorted list of k entries, CB candidate slots and a
  // candidate count
  static constexpr size_t smem(int qb, int k) {
    return 1024 + (size_t)STAGES * STAGE_BYTES + 64 + 8 * (size_t)qb * (k + CB) +
           4 * (size_t)qb;
  }
  static_assert(STAGES * 8 <= 64, "stage barriers");
};

using Mid = Cfg<2, 2, 3, 16>;     // 128 queries x 256 rows
using Large = Cfg<4, 1, 3, 16>;   // 256 queries x 128 rows

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

// TMA: both operands arrive by tensor copies (one thread issues them; a
// barrier per stage counts the bytes), 128-byte swizzled as wgmma reads
// them; rows and depth past the tensors' edges come back zero. Otherwise
// (rows not 16-byte aligned) every thread stages by scalar loads.
template <class C, typename Sel, bool TMA>
__global__ void __launch_bounds__(C::THREADS, 1) range_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ x, int nq,
    int n_eff, int d, int k, int qb, int range_rows, KeyParams kp,
    typename Sel::E* __restrict__ cand, const __grid_constant__ CUtensorMap tmq,
    const __grid_constant__ CUtensorMap tmx) {
  using E = typename Sel::E;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t sbase = (raw + 1023) & ~1023u;
  const uint32_t bars = sbase + C::STAGES * C::STAGE_BYTES;   // [STAGES] mbarriers
  unsigned char* tail = smem_raw + (sbase - raw) + (size_t)C::STAGES * C::STAGE_BYTES + 64;
  E* lst = reinterpret_cast<E*>(tail);                            // [qb][k]
  E* cbuf = lst + (size_t)qb * k;                                 // [qb][CB]
  int* cnt = reinterpret_cast<int*>(cbuf + (size_t)qb * C::CB);  // [qb]

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int wgi = warp >> 2, wm = wgi / C::WN, wn = wgi % C::WN;
  const int q0 = blockIdx.y * qb;
  const int qlim = min(qb, nq - q0);
  const int r_begin = blockIdx.x * range_rows;
  const int r_end = min(r_begin + range_rows, n_eff);
  init_lists<Sel>(lst, cnt, qb, k, t, C::THREADS);

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

  float acc[1][16][4] = {};
  for (int step = 0; step < total; ++step) {
    if (TMA) {
      mbar_wait(bars + 8 * (step % C::STAGES), (step / C::STAGES) & 1);
    } else {   // this thread's stores -> the async proxy wgmma reads through
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();   // slice `step` landed; slice step-1's wgmma done everywhere
    const uint32_t st = sbase + (step % C::STAGES) * C::STAGE_BYTES;
    const uint64_t da = desc(st + wm * 64 * DK * 2);
    const uint64_t db = desc(st + (C::QT + wn * 128) * DK * 2);
    fence_operands(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < DK / 16; ++kk)   // 32 bytes along each swizzled row
      wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // while the tensor cores run: the stage slice step-1 used
    if (step + C::STAGES - 1 < total && (!TMA || t == 0)) issue(step + C::STAGES - 1);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc);
    if (step % ksteps != ksteps - 1) continue;
    select_tile<Sel, 1, 16, C::WARPS, C::CB>(acc, wm * 64 + (warp & 3) * 16, wn * 128,
                                             r_begin + (step / ksteps) * C::TN, r_end, qlim,
                                             k, lst, cbuf, cnt, kp, warp, lane);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[0][j][v] = 0.f;
  }
  finish<Sel, C::WARPS, C::CB>(lst, cbuf, cnt, q0, qlim, k, t, C::THREADS, kp, cand);
}

}  // namespace wg

}  // namespace tc

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

// Pass-1 configurations, numbered as the wrapper's plan names them.
enum { FMA32 = 0, FMA8 = 1, TC_MID = 2, TC_LARGE = 3 };

size_t smem_bytes(int cfg, int qb, int k) {
  switch (cfg) {
    case FMA32: return f32scan::Tile<32, 64>::smem(k);
    case FMA8: return f32scan::Tile<8, 128>::smem(k);
    case TC_MID: return tc::wg::Mid::smem(qb, k);
    case TC_LARGE: return tc::wg::Large::smem(qb, k);
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

template <typename Sel>
using WgKernel = void (*)(const __nv_bfloat16*, const __nv_bfloat16*, int, int, int, int, int,
                          int, KeyParams, typename Sel::E*, const CUtensorMap, const CUtensorMap);

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

// a row-major bf16 [rows, d] tensor read in boxes of {64 deep, box_rows},
// 128-byte swizzled, zero past its edges
bool tensor_map(CUtensorMap* m, const void* base, int rows, int d, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)(rows > 0 ? rows : 1)};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {(cuuint32_t)tc::DK, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class C, typename Sel>
cudaError_t launch_wg(int vec, const void* q, const void* x, int nq, int n_eff, int d, int k,
                      int qb, int n_ranges, int range_rows, KeyParams kp,
                      typename Sel::E* cand, cudaStream_t st) {
  CUtensorMap tmq{}, tmx{};
  if (vec && !(tensor_map(&tmq, q, nq, d, C::QT) && tensor_map(&tmx, x, n_eff, d, C::TN)))
    return cudaErrorInvalidValue;
  const WgKernel<Sel> kern = vec ? tc::wg::range_kernel<C, Sel, true>
                                 : tc::wg::range_kernel<C, Sel, false>;
  const size_t smem = C::smem(qb, k);
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(n_ranges, (nq + qb - 1) / qb), C::THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(x), nq, n_eff,
      d, k, qb, range_rows, kp, cand, tmq, tmx);
  return cudaGetLastError();
}

template <typename Sel>
int launch(const void* q, const void* x, int cfg, int vec, int nq, int n_eff, int d, int k,
           int qb, int n_ranges, int range_rows, KeyParams kp, void* cand_p, void* out_v,
           void* out_i, cudaStream_t st) {
  using E = typename Sel::E;
  E* cand = static_cast<E*>(cand_p);
  cudaError_t e;
  switch (cfg) {
    case FMA32:
      e = launch_fma<Sel, 32, 64>(q, x, nq, n_eff, d, k, n_ranges, range_rows, kp, cand, st);
      break;
    case FMA8:
      e = launch_fma<Sel, 8, 128>(q, x, nq, n_eff, d, k, n_ranges, range_rows, kp, cand, st);
      break;
    case TC_MID:
      e = launch_wg<tc::wg::Mid, Sel>(vec, q, x, nq, n_eff, d, k, qb, n_ranges, range_rows, kp,
                                      cand, st);
      break;
    case TC_LARGE:
      e = launch_wg<tc::wg::Large, Sel>(vec, q, x, nq, n_eff, d, k, qb, n_ranges, range_rows,
                                        kp, cand, st);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return (int)e;
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

// Shared memory pass 1 needs in configuration cfg (FMA32 and FMA8 for f32
// operands, TC_* for bf16) with qb queries per block (TC_*) at this k.
size_t topk_smem_bytes(int cfg, int qb, int k) { return smem_bytes(cfg, qb, k); }

// q [nq, d], x [>= n_eff, d]: f32 for cfg FMA32/FMA8, bf16 for cfg TC_*;
// only rows < n_eff are candidates. qb: queries per block (TC_*; the FMA
// configurations take 32 and 8). vec = 1: rows and bases 16-byte aligned,
// so TC_* stage by TMA.
// fast = 1 selects fast mode with lane_bits, chunk_log2 and n_chunks
// (ignored in exact mode). cand: [nq, n_ranges, k] 8-byte scratch;
// out_v/out_i: [nq, k]. Returns cudaGetLastError().
int topk_launch(const void* q, const void* x, int cfg, int vec, int nq, int n_eff, int d,
                int k, int qb, int n_ranges, int range_rows, int fast, int lane_bits,
                int chunk_log2, int n_chunks, void* cand, void* out_v, void* out_i,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const KeyParams kp{lane_bits, chunk_log2, n_chunks};
  if (fast)
    return launch<FastSel>(q, x, cfg, vec, nq, n_eff, d, k, qb, n_ranges, range_rows, kp,
                           cand, out_v, out_i, st);
  return launch<ExactSel>(q, x, cfg, vec, nq, n_eff, d, k, qb, n_ranges, range_rows, kp,
                          cand, out_v, out_i, st);
}

}  // extern "C"
