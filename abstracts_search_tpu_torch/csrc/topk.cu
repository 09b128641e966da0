// Streaming exact top-k of q . x^T for Hopper (sm_90a).
//
// Replaces abstracts_search_tpu/ops/topk.py::_topk_kernel (with its fold
// _fold_exact). Same contract: scores accumulate in f32 (bf16 operands
// are widened; their products are exact in f32), rows at or past n_valid
// never win, ties go to the lowest row, and slots with no candidate come
// back as (-inf, 0).
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
//     heads), under the same (value desc, row asc) order.
//
// What bounds it: at the probe shape (65,536 x 1024 bf16 centroids, Q up
// to one tile) the 128 MiB read, ~40 us at 3.35 TB/s. Larger Q re-reads
// the corpus once per query tile and moves toward the f32 FMA rate; tensor
// cores (mma/wgmma) are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int DK = 32;                  // depth staged per step
constexpr int IDX_NONE = 0x7fffffff;    // empty list slot
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int QT, int TN>
struct Tile {
  static constexpr int QPT = QT >= 16 ? QT / 16 : 1;   // queries per thread
  static constexpr int NQG = QT / QPT;                 // query groups
  static constexpr int NRG = THREADS / NQG;            // row groups
  static constexpr int RPT = TN / NRG;                 // rows per thread
  static_assert(NQG * NRG == THREADS, "thread layout");
  static_assert(RPT * NRG == TN, "row layout");
  static_assert(TN % 32 == 0, "selection layout");
  static size_t smem(int k) {
    return sizeof(float) * (QT * DK + TN * (DK + 1) + QT * TN) +
           (sizeof(float) + sizeof(int)) * (size_t)QT * k;
  }
};

template <typename T, int QT, int TN>
__global__ void __launch_bounds__(THREADS) topk_range_kernel(
    const T* __restrict__ q, const T* __restrict__ x, int nq, int n_eff, int d,
    int k, int range_rows, float* __restrict__ cand_v, int* __restrict__ cand_i) {
  using L = Tile<QT, TN>;
  constexpr int WARPS = THREADS / 32;

  extern __shared__ float smem[];
  float* qs = smem;                                  // [QT][DK]
  float* xs = qs + QT * DK;                          // [TN][DK + 1]
  float* sc = xs + TN * (DK + 1);                    // [QT][TN]
  float* lv = sc + QT * TN;                          // [QT][k] values
  int* li = reinterpret_cast<int*>(lv + QT * k);     // [QT][k] rows

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int tq = t / L::NRG, tr = t % L::NRG;
  const int q0 = blockIdx.y * QT;
  const int r_begin = blockIdx.x * range_rows;
  const int r_end = min(r_begin + range_rows, n_eff);

  for (int e = t; e < QT * k; e += THREADS) {
    lv[e] = -INFINITY;
    li[e] = IDX_NONE;
  }

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
      float* v = lv + qi * k;
      int* ix = li + qi * k;
      for (int s = 0; s < TN / 32; ++s) {
        const int ri = s * 32 + lane;
        const float cv = sc[qi * TN + ri];
        const int cr = r0 + ri;
        const bool want = cv != -INFINITY && better(cv, cr, v[k - 1], ix[k - 1]);
        unsigned mask = __ballot_sync(FULL, want);
        while (mask) {
          const int src = __ffs(mask) - 1;
          mask &= mask - 1;
          const float nv = __shfl_sync(FULL, cv, src);
          const int nr = __shfl_sync(FULL, cr, src);
          if (!better(nv, nr, v[k - 1], ix[k - 1])) continue;  // warp-uniform
          int pos = 0;  // entries better than the candidate (list is sorted)
          for (int p = lane; p < k; p += 32) pos += better(v[p], ix[p], nv, nr);
#pragma unroll
          for (int o = 16; o; o >>= 1) pos += __shfl_xor_sync(FULL, pos, o);
          // shift [pos, k-2] right by one, highest block of 32 first
          for (int base = ((k - 1) / 32) * 32; base >= 0; base -= 32) {
            const int p = base + lane;
            const bool act = p > pos && p < k;
            float tv = 0.f;
            int ti = 0;
            if (act) {
              tv = v[p - 1];
              ti = ix[p - 1];
            }
            __syncwarp();
            if (act) {
              v[p] = tv;
              ix[p] = ti;
            }
            __syncwarp();
          }
          if (lane == 0) {
            v[pos] = nv;
            ix[pos] = nr;
          }
          __syncwarp();
        }
      }
    }
  }
  __syncthreads();
  for (int e = t; e < QT * k; e += THREADS) {
    const int qi = e / k, p = e % k, gq = q0 + qi;
    if (gq < nq) {
      const size_t o = ((size_t)gq * gridDim.x + blockIdx.x) * k + p;
      cand_v[o] = lv[e];
      cand_i[o] = li[e];
    }
  }
}

// One block per query: k rounds of a block-wide argmax over the heads of
// the sorted per-range lists.
__global__ void __launch_bounds__(THREADS) topk_merge_kernel(
    const float* __restrict__ cand_v, const int* __restrict__ cand_i, int n_ranges,
    int k, float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ int ptr[];  // [n_ranges] head of each range list
  __shared__ float wv[THREADS / 32];
  __shared__ int wi[THREADS / 32], wr[THREADS / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t base = (size_t)blockIdx.x * n_ranges * k;
  for (int r = t; r < n_ranges; r += THREADS) ptr[r] = 0;
  __syncthreads();
  for (int j = 0; j < k; ++j) {
    float bv = -INFINITY;
    int bi = IDX_NONE, br = -1;
    for (int r = t; r < n_ranges; r += THREADS) {
      const int p = ptr[r];
      if (p < k) {
        const float v = cand_v[base + (size_t)r * k + p];
        const int i = cand_i[base + (size_t)r * k + p];
        if (better(v, i, bv, bi)) {
          bv = v;
          bi = i;
          br = r;
        }
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bv, o);
      const int oi = __shfl_xor_sync(FULL, bi, o);
      const int orr = __shfl_xor_sync(FULL, br, o);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
        br = orr;
      }
    }
    if (lane == 0) {
      wv[warp] = bv;
      wi[warp] = bi;
      wr[warp] = br;
    }
    __syncthreads();
    if (t == 0) {
      for (int w = 1; w < THREADS / 32; ++w)
        if (better(wv[w], wi[w], bv, bi)) {
          bv = wv[w];
          bi = wi[w];
          br = wr[w];
        }
      const bool none = bv == -INFINITY;
      out_v[(size_t)blockIdx.x * k + j] = none ? -INFINITY : bv;
      out_i[(size_t)blockIdx.x * k + j] = none ? 0 : bi;
      if (!none) ptr[br] += 1;
    }
    __syncthreads();
  }
}

template <typename T, int QT, int TN>
cudaError_t launch_ranges(const void* q, const void* x, int nq, int n_eff, int d,
                          int k, int n_ranges, int range_rows, float* cv, int* ci,
                          cudaStream_t st) {
  const size_t smem = Tile<QT, TN>::smem(k);
  cudaError_t e = cudaFuncSetAttribute(topk_range_kernel<T, QT, TN>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(n_ranges, (nq + QT - 1) / QT);
  topk_range_kernel<T, QT, TN><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(x), nq, n_eff, d, k,
      range_rows, cv, ci);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory pass 1 needs for a query tile of qt (8 or 32) at this k.
size_t topk_smem_bytes(int qt, int k) {
  return qt == 32 ? Tile<32, 64>::smem(k) : Tile<8, 128>::smem(k);
}

// q [nq, d], x [>= n_eff, d], both f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// only rows < n_eff are candidates. cand_v/cand_i: [nq, n_ranges, k]
// scratch; out_v/out_i: [nq, k]. Returns cudaGetLastError().
int topk_launch(const void* q, const void* x, int is_bf16, int nq, int n_eff, int d,
                int k, int qt, int n_ranges, int range_rows, void* cand_v,
                void* cand_i, void* out_v, void* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* cv = static_cast<float*>(cand_v);
  int* ci = static_cast<int*>(cand_i);
  cudaError_t e;
  if (qt == 32)
    e = is_bf16 ? launch_ranges<__nv_bfloat16, 32, 64>(q, x, nq, n_eff, d, k, n_ranges,
                                                       range_rows, cv, ci, st)
                : launch_ranges<float, 32, 64>(q, x, nq, n_eff, d, k, n_ranges,
                                               range_rows, cv, ci, st);
  else if (qt == 8)
    e = is_bf16 ? launch_ranges<__nv_bfloat16, 8, 128>(q, x, nq, n_eff, d, k, n_ranges,
                                                       range_rows, cv, ci, st)
                : launch_ranges<float, 8, 128>(q, x, nq, n_eff, d, k, n_ranges,
                                               range_rows, cv, ci, st);
  else
    return (int)cudaErrorInvalidValue;
  if (e != cudaSuccess) return (int)e;
  const size_t smem2 = sizeof(int) * (size_t)n_ranges;
  e = cudaFuncSetAttribute(topk_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem2);
  if (e != cudaSuccess) return (int)e;
  topk_merge_kernel<<<nq, THREADS, smem2, st>>>(cv, ci, n_ranges, k,
                                                static_cast<float*>(out_v),
                                                static_cast<int*>(out_i));
  return (int)cudaGetLastError();
}

}  // extern "C"
