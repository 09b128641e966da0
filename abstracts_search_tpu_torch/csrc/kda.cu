// The gated delta rule of Kimi Delta Attention (KDA), chunked, for Hopper
// (sm_90a). Written for the port: the JAX package has no linear-attention
// layer.
//
// Per sequence and head, with a state S [D, D] in f32 that starts at 0:
//   S_t = (I - b_t k_t k_t^T) Diag(exp g_t) S_{t-1} + b_t k_t v_t^T
//   o_t = S_t^T q_t
// q, k, v, o [B, T, H, D] bf16 at KDA's head width D = 128, the
// log-decays g [B, T, H, D] f32 (each <= 0), b = beta [B, T, H] f32.
//
// The sequence is cut into chunks of C = 64 tokens. Inside a chunk, with G
// the cumulative log-decay from the chunk's start and Gamma = exp(G), the
// delta rule's writes W solve (I + diag(b) A) W = diag(b) (V - (K o Gamma)
// S_0), where A[t, s] = sum_c k_tc k_sc exp(G_tc - G_sc) for s < t (the
// WY/UT form). With T = (I + diag(b) A)^-1:
//   W   = U + Wn S_0,          U = T diag(b) V,  Wn = -T diag(b) (K o Gamma)
//   O   = (Q o Gamma) S_0 + M W,   M[t, s] = sum_c q_tc k_sc exp(G_tc - G_sc), s <= t
//   S_C = Diag(Gamma_C) S_0 + (K o exp(G_C - G))^T W.
//
// kda_intra_kernel, one block a chunk and head, all chunks at once: A and
// M, the inverse T, and what the state pass reads of the chunk: U (f32),
// Wn, M, Q o Gamma, K o exp(G_C - G) (bf16) and Gamma_C (f32).
// kda_state_kernel, one block a head and 64 value columns: walks the
// chunks in order with its columns of the state in shared memory (f32, a
// bf16 copy for the products): W, then O and the next state.
//
// Decays: exp(G_t - G_s) taken as exp(G_t) exp(-G_s) overflows once a
// chunk's decay passes e^-88, which strong channels reach in a few tokens.
// So no factor here has a positive exponent. A and M are built over
// blocks of 16 rows: a block below the diagonal (rows 16i.., columns
// 16j.., j < i) pivots on the row p = 16i - 1 between them,
// (K_i o exp(G_i - G_p)) (K_j o exp(G_p - G_j))^T, both factors <= 1, on
// tensor cores (bf16 operands, f32 sums); the diagonal blocks take each
// exp(G_tc - G_sc) on their own, in f32. The inverse is a forward
// substitution in f32: the diagonal blocks' inverses row by row, then
// X_ij = -X_ii sum_{k=j}^{i-1} N_ik X_kj, N = diag(b) A. (A power series
// (I - N)(I + N^2)(I + N^4)... would be shorter, but when keys run alike
// its terms grow far past T and f32 loses it.) Every other product takes
// bf16 operands and sums in f32; the state and the decays stay in f32.
//
// What bounds them: bandwidth. q, k, v, the f32 decays in and o out are
// about 0.8 GB a layer of 32 x 512 tokens x 32 heads of 128, against about
// 60 GFLOP of recurrence; the chunk-local intermediates (U in f32, the
// rest bf16) make a second round trip of about the same size.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace kda {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int D = 128;   // a head's key and value width
constexpr int C = 64;    // tokens a chunk
constexpr int NT = 256;  // threads a block (8 warps)
constexpr int NW = NT / 32;
constexpr int BV = 64;   // value columns a state block holds

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBT = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using Acc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ bf16 b16(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

constexpr int intra_smem_bytes() {
  // G f32 [C][D]; K, Q (later V), the pivoted operands (later K o Gamma)
  // bf16 [C][D]; A (later T diag(b) in bf16 and the warps' staging) and M
  // (later the inverse) f32 [C][C]; beta f32 [C]
  return C * D * 4 + 3 * C * D * 2 + 2 * C * C * 4 + C * 4;
}

constexpr int state_smem_bytes() {
  // S f32 [D][BV] and its bf16 copy; W bf16 [C][BV]; W, then O, f32
  // [C][BV]; Gamma_C f32 [D]
  return D * BV * 4 + D * BV * 2 + C * BV * 2 + C * BV * 4 + D * 4;
}

__global__ void __launch_bounds__(NT, 2)
    kda_intra_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ beta, float* __restrict__ u,
                     bf16* __restrict__ wn, bf16* __restrict__ mo, bf16* __restrict__ qg,
                     bf16* __restrict__ kd, float* __restrict__ gl, int T, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sG = reinterpret_cast<float*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(sG + C * D);
  bf16* sQ = sK + C * D;   // later V
  bf16* sLR = sQ + C * D;  // L [16][D] and R [48][D]; later K o Gamma
  float* sA = reinterpret_cast<float*>(sLR + C * D);  // A, then N; later T diag(b), staging
  float* sM = sA + C * C;                             // M; later the inverse X
  float* sB = sM + C * C;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int nt = (T + C - 1) / C;
  const long ci = (long)bh * nt + n;  // the chunk's index in the outputs
  const auto at = [&](int r) { return (((long)b * T + n * C + r) * H + h) * D; };

  // -- the chunk's rows (zero past the sequence's end)
  for (int i = tid; i < C * D / 8; i += NT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const bool live = n * C + r < T;
    uint4 kv = make_uint4(0, 0, 0, 0), qv = kv;
    float4 g0 = make_float4(0.f, 0.f, 0.f, 0.f), g1 = g0;
    if (live) {
      kv = *reinterpret_cast<const uint4*>(k + at(r) + c);
      qv = *reinterpret_cast<const uint4*>(q + at(r) + c);
      g0 = *reinterpret_cast<const float4*>(g + at(r) + c);
      g1 = *reinterpret_cast<const float4*>(g + at(r) + c + 4);
    }
    *reinterpret_cast<uint4*>(sK + r * D + c) = kv;
    *reinterpret_cast<uint4*>(sQ + r * D + c) = qv;
    *reinterpret_cast<float4*>(sG + r * D + c) = g0;
    *reinterpret_cast<float4*>(sG + r * D + c + 4) = g1;
  }
  if (tid < C) sB[tid] = n * C + tid < T ? beta[((long)b * T + n * C + tid) * H + h] : 0.f;
  for (int i = tid; i < 2 * C * C; i += NT) sA[i] = 0.f;  // A and M
  __syncthreads();
  // cumulative log-decays from the chunk's start, a channel a thread
  for (int c = tid; c < D; c += NT) {
    float acc = 0.f;
    for (int r = 0; r < C; ++r) {
      acc += sG[r * D + c];
      sG[r * D + c] = acc;
    }
  }
  __syncthreads();

  // -- the diagonal blocks of A and M, a pair (t, s) at a time, a warp a
  //    row (rows w and 15 - w of each block: 17 pairs a block for each
  //    warp), a lane D/32 channels
  constexpr int J = D / 32;
  for (int blk = 0; blk < C / 16; ++blk) {
    for (int half = 0; half < 2; ++half) {
      const int t = 16 * blk + (half ? 15 - warp : warp);
      float kt[J], qt[J], gt[J];
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        kt[j] = f(sK[t * D + c]);
        qt[j] = f(sQ[t * D + c]);
        gt[j] = sG[t * D + c];
      }
      for (int s = 16 * blk; s <= t; ++s) {
        float a = 0.f, m = 0.f;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = lane + 32 * j;
          const float e = f(sK[s * D + c]) * __expf(gt[j] - sG[s * D + c]);
          a += kt[j] * e;
          m += qt[j] * e;
        }
        a = warp_sum(a);
        m = warp_sum(m);
        if (lane == 0) {
          if (s < t) sA[t * C + s] = a;
          sM[t * C + s] = m;
        }
      }
    }
  }

  // -- the blocks below the diagonal, pivoted on row p = 16i - 1
  bf16* sL = sLR;
  bf16* sR = sLR + 16 * D;
  for (int i = 1; i < C / 16; ++i) {
    const int p = 16 * i - 1;
    for (int idx = tid; idx < 16 * i * D; idx += NT) {
      const int c = idx % D;
      sR[idx] = b16(f(sK[idx]) * __expf(sG[p * D + c] - sG[idx]));
    }
    for (int side = 0; side < 2; ++side) {
      const bf16* x = side ? sQ : sK;
      float* out = side ? sM : sA;
      for (int idx = tid; idx < 16 * D; idx += NT) {
        const int c = idx % D, at_t = 16 * i * D + idx;
        sL[idx] = b16(f(x[at_t]) * __expf(sG[at_t] - sG[p * D + c]));
      }
      __syncthreads();
      if (warp < i) {
        Acc acc;
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          FragA a;
          FragBT r;
          wmma::load_matrix_sync(a, sL + 16 * kk, D);
          wmma::load_matrix_sync(r, sR + 16 * warp * D + 16 * kk, D);
          wmma::mma_sync(acc, a, r, acc);
        }
        wmma::store_matrix_sync(out + 16 * i * C + 16 * warp, acc, C, wmma::mem_row_major);
      }
      __syncthreads();
    }
  }

  // -- what the state pass reads besides U and Wn: Q o Gamma, K o
  //    exp(G_C - G), Gamma_C, M
  for (int i = tid; i < C * D; i += NT) {
    const int c = i % D;
    const float gi = sG[i], gc = sG[(C - 1) * D + c];
    qg[ci * C * D + i] = b16(f(sQ[i]) * __expf(gi));
    kd[ci * C * D + i] = b16(f(sK[i]) * __expf(gc - gi));
  }
  for (int c = tid; c < D; c += NT) gl[ci * D + c] = __expf(sG[(C - 1) * D + c]);
  for (int i = tid; i < C * C; i += NT) mo[ci * C * C + i] = b16(sM[i]);
  __syncthreads();

  // -- the inverse X = (I + N)^-1, N = diag(b) A strictly lower
  float* sN = sA;
  float* sX = sM;
  for (int i = tid; i < C * C; i += NT) {
    const int t = i / C, s = i % C;
    sN[i] = s < t ? sB[t] * sN[i] : 0.f;
    sX[i] = 0.f;
  }
  __syncthreads();
  if (tid < C) {  // the diagonal blocks, a column a thread
    const int base = 16 * (tid / 16), j = tid % 16;
    float x[16];
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      float val = r == j ? 1.f : 0.f;
#pragma unroll
      for (int kk = 0; kk < r; ++kk) val -= sN[(base + r) * C + base + kk] * x[kk];
      x[r] = val;
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) sX[(base + r) * C + base + j] = x[r];
  }
  __syncthreads();
  {
    const int r = tid / 16, cc = tid % 16;
    for (int i = 1; i < C / 16; ++i) {
      float pv[C / 16 - 1];
#pragma unroll
      for (int j = 0; j < C / 16 - 1; ++j) {
        if (j >= i) break;
        float acc = 0.f;
        for (int kb = j; kb < i; ++kb)
#pragma unroll
          for (int m = 0; m < 16; ++m)
            acc += sN[(16 * i + r) * C + 16 * kb + m] * sX[(16 * kb + m) * C + 16 * j + cc];
        pv[j] = acc;
      }
      __syncthreads();  // P_ij over N_ij, once every N_ik is read
#pragma unroll
      for (int j = 0; j < C / 16 - 1; ++j)
        if (j < i) sN[(16 * i + r) * C + 16 * j + cc] = pv[j];
      __syncthreads();
#pragma unroll
      for (int j = 0; j < C / 16 - 1; ++j) {
        if (j >= i) break;
        float acc = 0.f;
#pragma unroll
        for (int m = 0; m < 16; ++m)
          acc -= sX[(16 * i + r) * C + 16 * i + m] * sN[(16 * i + m) * C + 16 * j + cc];
        sX[(16 * i + r) * C + 16 * j + cc] = acc;
      }
      __syncthreads();
    }
  }

  // -- U = T diag(b) V (f32, straight to memory) and Wn = -T diag(b) (K o
  //    Gamma) (bf16, through each warp's staging)
  bf16* sTb = reinterpret_cast<bf16*>(sA);
  float* stage = reinterpret_cast<float*>(sTb + C * C) + warp * 256;
  bf16* sV = sQ;
  bf16* sKG = sLR;
  for (int i = tid; i < C * C; i += NT) sTb[i] = b16(sX[i] * sB[i % C]);
  for (int i = tid; i < C * D / 8; i += NT) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    uint4 vv = make_uint4(0, 0, 0, 0);
    if (n * C + r < T) vv = *reinterpret_cast<const uint4*>(v + at(r) + c);
    *reinterpret_cast<uint4*>(sV + r * D + c) = vv;
  }
  for (int i = tid; i < C * D; i += NT) sKG[i] = b16(f(sK[i]) * __expf(sG[i]));
  __syncthreads();
  for (int tile = warp; tile < (C / 16) * (D / 16); tile += NW) {
    const int tr = tile / (D / 16), tc = tile % (D / 16);
    Acc ua, wa;
    wmma::fill_fragment(ua, 0.f);
    wmma::fill_fragment(wa, 0.f);
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk) {
      FragA a;
      FragB bv, bk;
      wmma::load_matrix_sync(a, sTb + 16 * tr * C + 16 * kk, C);
      wmma::load_matrix_sync(bv, sV + 16 * kk * D + 16 * tc, D);
      wmma::load_matrix_sync(bk, sKG + 16 * kk * D + 16 * tc, D);
      wmma::mma_sync(ua, a, bv, ua);
      wmma::mma_sync(wa, a, bk, wa);
    }
    wmma::store_matrix_sync(u + (ci * C + 16 * tr) * D + 16 * tc, ua, D, wmma::mem_row_major);
    wmma::store_matrix_sync(stage, wa, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32)
      wn[(ci * C + 16 * tr + e / 16) * D + 16 * tc + e % 16] = b16(-stage[e]);
    __syncwarp();
  }
}

__global__ void __launch_bounds__(NT, 2)
    kda_state_kernel(const float* __restrict__ u, const bf16* __restrict__ wn,
                     const bf16* __restrict__ mo, const bf16* __restrict__ qg,
                     const bf16* __restrict__ kd, const float* __restrict__ gl,
                     bf16* __restrict__ o, int T, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sS = reinterpret_cast<float*>(smem);
  bf16* sSb = reinterpret_cast<bf16*>(sS + D * BV);
  bf16* sWb = sSb + D * BV;
  float* sF = reinterpret_cast<float*>(sWb + C * BV);
  float* sGl = sF + C * BV;

  const int tid = threadIdx.x, warp = tid / 32;
  const int vb = blockIdx.x, bh = blockIdx.y, b = bh / H, h = bh % H;
  const int nt = (T + C - 1) / C;
  for (int i = tid; i < D * BV; i += NT) {
    sS[i] = 0.f;
    sSb[i] = b16(0.f);
  }
  __syncthreads();
  for (int n = 0; n < nt; ++n) {
    const long ci = (long)bh * nt + n;
    const float* un = u + ci * C * D + vb * BV;
    const bf16* wnn = wn + ci * C * D;
    const bf16* qgn = qg + ci * C * D;
    const bf16* kdn = kd + ci * C * D;
    const bf16* mn = mo + ci * C * C;
    // W = U + Wn S, into sF
    for (int tile = warp; tile < (C / 16) * (BV / 16); tile += NW) {
      const int tr = tile / (BV / 16), tv = tile % (BV / 16);
      Acc acc;
      wmma::load_matrix_sync(acc, un + 16 * tr * D + 16 * tv, D, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        FragA a;
        FragB s;
        wmma::load_matrix_sync(a, wnn + 16 * tr * D + 16 * kk, D);
        wmma::load_matrix_sync(s, sSb + 16 * kk * BV + 16 * tv, BV);
        wmma::mma_sync(acc, a, s, acc);
      }
      wmma::store_matrix_sync(sF + 16 * tr * BV + 16 * tv, acc, BV, wmma::mem_row_major);
    }
    for (int c = tid; c < D; c += NT) sGl[c] = gl[ci * D + c];
    __syncthreads();
    for (int i = tid; i < C * BV; i += NT) sWb[i] = b16(sF[i]);
    for (int i = tid; i < D * BV; i += NT) sS[i] *= sGl[i / BV];
    __syncthreads();
    // O = (Q o Gamma) S + M W, into sF; beside it S = Diag(Gamma_C) S +
    // (K o exp(G_C - G))^T W
    for (int tile = warp; tile < (C / 16) * (BV / 16); tile += NW) {
      const int tr = tile / (BV / 16), tv = tile % (BV / 16);
      Acc acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        FragA a;
        FragB s;
        wmma::load_matrix_sync(a, qgn + 16 * tr * D + 16 * kk, D);
        wmma::load_matrix_sync(s, sSb + 16 * kk * BV + 16 * tv, BV);
        wmma::mma_sync(acc, a, s, acc);
      }
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        FragA a;
        FragB w;
        wmma::load_matrix_sync(a, mn + 16 * tr * C + 16 * kk, C);
        wmma::load_matrix_sync(w, sWb + 16 * kk * BV + 16 * tv, BV);
        wmma::mma_sync(acc, a, w, acc);
      }
      wmma::store_matrix_sync(sF + 16 * tr * BV + 16 * tv, acc, BV, wmma::mem_row_major);
    }
    for (int tile = warp; tile < (D / 16) * (BV / 16); tile += NW) {
      const int tc = tile / (BV / 16), tv = tile % (BV / 16);
      Acc acc;
      wmma::load_matrix_sync(acc, sS + 16 * tc * BV + 16 * tv, BV, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk) {
        FragAT a;  // (K o exp(G_C - G))^T: the chunk's rows read column-major
        FragB w;
        wmma::load_matrix_sync(a, kdn + 16 * kk * D + 16 * tc, D);
        wmma::load_matrix_sync(w, sWb + 16 * kk * BV + 16 * tv, BV);
        wmma::mma_sync(acc, a, w, acc);
      }
      wmma::store_matrix_sync(sS + 16 * tc * BV + 16 * tv, acc, BV, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = tid; i < C * BV; i += NT) {
      const int r = i / BV;
      if (n * C + r < T)
        o[(((long)b * T + n * C + r) * H + h) * D + vb * BV + i % BV] = b16(sF[i]);
    }
    for (int i = tid; i < D * BV; i += NT) sSb[i] = b16(sS[i]);
    __syncthreads();
  }
}

int launch(const void* q, const void* k, const void* v, const void* g, const void* beta,
           void* u, void* wn, void* mo, void* qg, void* kd, void* gl, void* o, int B, int T,
           int H, cudaStream_t stream) {
  const int nt = (T + C - 1) / C;
  cudaError_t e = cudaFuncSetAttribute(kda_intra_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       intra_smem_bytes());
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(kda_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           state_smem_bytes());
  if (e != cudaSuccess) return (int)e;
  kda_intra_kernel<<<dim3(nt, B * H), NT, intra_smem_bytes(), stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(g), static_cast<const float*>(beta), static_cast<float*>(u),
      static_cast<bf16*>(wn), static_cast<bf16*>(mo), static_cast<bf16*>(qg),
      static_cast<bf16*>(kd), static_cast<float*>(gl), T, H);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kda_state_kernel<<<dim3(D / BV, B * H), NT, state_smem_bytes(), stream>>>(
      static_cast<const float*>(u), static_cast<const bf16*>(wn), static_cast<const bf16*>(mo),
      static_cast<const bf16*>(qg), static_cast<const bf16*>(kd), static_cast<const float*>(gl),
      static_cast<bf16*>(o), T, H);
  return (int)cudaGetLastError();
}

}  // namespace kda

extern "C" {

// Tokens a chunk (ops/kda.py checks its own against this one).
int kda_chunk() { return kda::C; }

// q, k, v [B, T, H, D] bf16, g [B, T, H, D] f32, beta [B, T, H] f32 -> o
// [B, T, H, D] bf16, through the chunk-local buffers of nt = ceil(T / 64)
// chunks a head: u [B H, nt, 64, D] f32, wn, qg, kd [B H, nt, 64, D] bf16,
// mo [B H, nt, 64, 64] bf16, gl [B H, nt, D] f32, D = 128. Returns
// cudaGetLastError() (cudaErrorInvalidValue for another D).
int kda_launch(const void* q, const void* k, const void* v, const void* g, const void* beta,
               void* u, void* wn, void* mo, void* qg, void* kd, void* gl, void* o, int B, int T,
               int H, int D, void* stream) {
  if (D != kda::D) return (int)cudaErrorInvalidValue;
  return kda::launch(q, k, v, g, beta, u, wn, mo, qg, kd, gl, o, B, T, H,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
