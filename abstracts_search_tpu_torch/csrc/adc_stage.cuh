// The staging ring shared by every ADC kernel (the fused scan in
// adc_topk.cu, the raw scans in adc_scan.cu), for Hopper (sm_90a).
//
// A slot's payload codes[seg_ids[s]] is one contiguous block of
// tile_bytes. A block walks a contiguous slot range; consumer warp w takes
// the range's slots w, w + W, w + 2W, ... and reads each slot as nch
// chunks of at most chunk_bytes, in order, from its own D stages of shared
// memory. The warp keeps its stages filled itself: its lane 0 issues the
// 1-D bulk async copy (cp.async.bulk ... mbarrier::complete_tx::bytes) of
// chunk u + D into the stage that chunk u has just freed, and the stage's
// mbarrier counts the bytes. So each warp has D - 1 chunks in flight ahead
// of the one it reads, and no warp waits on another's copies.
//
// The query's LUT [m, ksub] f32 is staged into one of nl buffers (two
// where they fit beside the ring, so a block crosses a query boundary
// without a stall) by the block's producer warp (warp W). It walks the
// slots in order and posts each slot's buffer and load parity in a
// mailbox of MAIL entries per warp, so a warp that runs ahead of the
// others finds its next slots' LUTs posted. It reloads a buffer only when the slot's query is in
// neither, and only once every slot that used the buffer is done (the
// warps count their finished slots in done[w]); so a consumer's LUT
// barrier is never more than one phase from the load it waits for. q_ids
// may come in any order: query-major slots reload the LUT once per query,
// alternating ones keep two queries resident.
//
// A chunk or LUT whose address or size is not a multiple of 16 bytes is
// staged by plain copies of the issuing warp's 32 lanes, which then arrive
// on the same barrier.

#pragma once

#include <stdint.h>

namespace adc_stage {

constexpr int MAX_WARPS = 16;                 // consumer warps per block
constexpr int MAX_THREADS = 32 * (MAX_WARPS + 1);

constexpr int MAIL = 4;                       // mailbox entries per warp

__host__ __device__ constexpr int align16(long long b) { return (int)((b + 15) & ~15ll); }
__host__ __device__ constexpr int align256(long long b) { return (int)((b + 255) & ~255ll); }

// Shared-memory bytes of a block: up to 256 bytes to align the start, nl
// LUT buffers of align256(lut_bytes) (each 256-byte aligned, see
// lut_addr), W*D stages of align16(chunk_bytes), then the stage and LUT
// mbarriers (8 bytes each), and per warp its done and posted counters and
// MAIL mailbox entries (4 bytes each). Mirrored by ops/adc.py::_stage_smem.
__host__ __device__ constexpr long long smem_bytes(int W, int D, int chunk_bytes,
                                                  int lut_bytes, int nl) {
  return 256 + (long long)nl * align256(lut_bytes) + (long long)W * D * align16(chunk_bytes) +
         8ll * (W * D + nl) + 4ll * W * (2 + MAIL);
}

// One packed LUT entry by its 32-bit shared address.
__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

// Packed lookups by byte_perm. With the LUT 256-byte aligned, the table
// of subspace m starts at lut + 64 m, whose address has the low byte 0x00,
// 0x40, 0x80 or 0xC0, and 4 * nibble < 64. So a code word's nibbles times
// 4, with each byte's table low bits set in (lo_or, hi_or), and the upper
// three bytes of the table's address make each entry's address in one
// byte_perm, and the lookup is byte_perm + ld.shared.
struct Nibbles {
  uint32_t lo, hi;   // byte b: 4 * (low / high nibble of byte b) | table low bits
  __device__ __forceinline__ Nibbles(uint32_t w, uint32_t lo_or, uint32_t hi_or)
      : lo(((w << 2) & 0x3C3C3C3Cu) | lo_or), hi(((w >> 2) & 0x3C3C3C3Cu) | hi_or) {}
  // byte bb's entry in the table at base (only base's upper bytes count)
  __device__ __forceinline__ float lo_entry(uint32_t base, int bb) const {
    return lds(__byte_perm(lo, base, 0x7650 + bb));
  }
  __device__ __forceinline__ float hi_entry(uint32_t base, int bb) const {
    return lds(__byte_perm(hi, base, 0x7650 + bb));
  }
};

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void store_release(uint32_t* p, uint32_t v) {
  asm volatile("st.release.cta.shared.u32 [%0], %1;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(p)),
               "r"(v)
               : "memory");
}
__device__ __forceinline__ uint32_t load_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.cta.shared.u32 %0, [%1];\n"
               : "=r"(v)
               : "r"((uint32_t)__cvta_generic_to_shared(p))
               : "memory");
  return v;
}

// Phase counters, compiled in only with -DADC_PHASES (tools/adc_ab.py
// --phases): clock64 cycles per phase of the consumer warps, summed over
// the launch's warps into adc_phase_cycles.
#ifdef ADC_PHASES
__device__ unsigned long long adc_phase_cycles[8];
struct Phases {
  unsigned long long acc[8] = {};
  long long t = 0;
  __device__ void start() { t = clock64(); }
  __device__ void mark(int i) {
    const long long now = clock64();
    acc[i] += (unsigned long long)(now - t);
    t = now;
  }
  __device__ void flush(int lane) const {
    if (lane == 0)
      for (int i = 0; i < 8; ++i) atomicAdd(&adc_phase_cycles[i], acc[i]);
  }
};
#else
struct Phases {
  __device__ void start() {}
  __device__ void mark(int) {}
  __device__ void flush(int) const {}
};
#endif

struct Ring {
  unsigned char* stages;  // [W * D][chb]
  unsigned char* luts;    // [nl][lb]
  uint32_t full;          // shared address of the [W * D] stage barriers
  uint32_t lutbar;        // shared address of the [nl] LUT barriers
  uint32_t* done;         // [W] slots finished per warp
  uint32_t* posted;       // [W] slots whose LUT the producer has posted
  uint32_t* mail;         // [W][MAIL] LUT buffer | load parity << 8, by slot % MAIL
  int W, D, chb, lb, nl;

  __device__ Ring(unsigned char* smem, int W_, int D_, int chunk_bytes, int lut_bytes, int nl_)
      : W(W_), D(D_), chb(align16(chunk_bytes)), lb(align256(lut_bytes)), nl(nl_) {
    const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem);
    luts = smem + ((256 - (raw & 255)) & 255);
    stages = luts + (size_t)nl * lb;
    unsigned char* bars = stages + (size_t)W * D * chb;
    full = (uint32_t)__cvta_generic_to_shared(bars);
    lutbar = full + 8 * W * D;
    done = reinterpret_cast<uint32_t*>(bars + 8 * (W * D + nl));
    posted = done + W;
    mail = posted + W;
  }

  // thread 0, before the block's first __syncthreads
  __device__ void init() const {
    for (int i = 0; i < W * D; ++i) mbar_init(full + 8 * i);
    for (int i = 0; i < nl; ++i) mbar_init(lutbar + 8 * i);
    for (int i = 0; i < W; ++i) done[i] = posted[i] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // copy bytes from src to dst (shared), completing on barrier bar; a
  // whole warp calls it
  __device__ void copy(unsigned char* dst, const unsigned char* src, uint32_t bytes,
                       uint32_t bar, int lane) const {
    if ((((uintptr_t)src | bytes) & 15) == 0) {
      if (lane == 0) {
        mbar_expect(bar, bytes);
        bulk_copy((uint32_t)__cvta_generic_to_shared(dst), src, bytes, bar);
      }
    } else {
      for (uint32_t e = lane; e < bytes; e += 32) dst[e] = src[e];
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    }
    __syncwarp();
  }
};

// lane 0 waits until *p >= v; then the warp goes on
__device__ __forceinline__ void wait_count(const uint32_t* p, uint32_t v, int lane) {
  if (lane == 0)
    while (load_acquire(p) < v) __nanosleep(32);
  __syncwarp();
}

// One consumer warp's stages: it reads its chunks in order and refills
// each stage as soon as it has read it.
struct Feed {
  const Ring& g;
  const unsigned char* codes;
  const int* seg_ids;
  size_t tile_bytes;
  int chunk_bytes, nch, w, lane, s0, nslots;
  uint32_t total;           // chunks of this warp's slots
  uint32_t issued = 0;      // chunks issued
  int ik = 0, ic = 0;       // slot and chunk of the next issue
  int is = 0;               // its stage, 0..D-1
  int rs = 0;               // stage of the next read
  uint32_t rphase = 0;      // parity of the next read's stage phase
  int seg_next = 0;         // seg_ids of slot ik (prefetched a slot ahead)
  int seg_cur = 0;

  __device__ Feed(const Ring& g_, const unsigned char* codes_, const int* seg_ids_,
                  size_t tile_bytes_, int chunk_bytes_, int nch_, int w_, int lane_, int s0_,
                  int n)
      : g(g_), codes(codes_), seg_ids(seg_ids_), tile_bytes(tile_bytes_),
        chunk_bytes(chunk_bytes_), nch(nch_), w(w_), lane(lane_), s0(s0_) {
    nslots = w < n ? (n - w + g.W - 1) / g.W : 0;
    total = (uint32_t)nslots * nch;
    if (nslots > 0) seg_next = seg_ids[s0 + w];
    for (int d = 0; d < g.D && issued < total; ++d) issue();
  }

  __device__ void issue() {
    if (ic == 0) {
      seg_cur = seg_next;
      if (ik + 1 < nslots) seg_next = seg_ids[s0 + w + (ik + 1) * g.W];
    }
    const size_t off = (size_t)ic * chunk_bytes;
    const uint32_t bytes =
        (uint32_t)(tile_bytes - off < (size_t)chunk_bytes ? tile_bytes - off : chunk_bytes);
    const int st = w * g.D + is;
    g.copy(g.stages + (size_t)st * g.chb, codes + (size_t)seg_cur * tile_bytes + off, bytes,
           g.full + 8 * st, lane);
    ++issued;
    if (++ic == nch) ic = 0, ++ik;
    if (++is == g.D) is = 0;
  }

  // the LUT of this warp's k-th slot, once the producer has posted it
  __device__ const float* begin_slot(int k) const {
    wait_count(g.posted + w, (uint32_t)k + 1, lane);
    const uint32_t m = g.mail[MAIL * w + k % MAIL];
    const int b = (int)(m & 0xFF);
    mbar_wait(g.lutbar + 8 * b, (m >> 8) & 1);
    return reinterpret_cast<const float*>(g.luts + (size_t)b * g.lb);
  }
  // the next chunk, once it has landed
  __device__ const unsigned char* wait_chunk() const {
    const int st = w * g.D + rs;
    mbar_wait(g.full + 8 * st, rphase);
    return g.stages + (size_t)st * g.chb;
  }
  // every lane has read the chunk: refill its stage
  __device__ void next() {
    __syncwarp();
    if (lane == 0) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (issued < total) issue();
    if (++rs == g.D) rs = 0, rphase ^= 1;
  }
  // the k-th slot's chunks and LUT are no longer read
  __device__ void end_slot(int k) const {
    __syncwarp();
    if (lane == 0) store_release(g.done + w, (uint32_t)k + 1);
  }
};

// The producer warp: each slot's LUT buffer, in slot order, posted at most
// MAIL slots ahead of its warp. A buffer is overwritten only once every
// slot that used it is done; those slots' chunks need no producer, so the
// wait always ends.
__device__ __forceinline__ void post_luts(const Ring& g, const float* luts, const int* q_ids,
                                          int s0, int n, int lut_bytes, int lane) {
  int lq[2] = {-1, -1};        // query held by each LUT buffer
  uint32_t loads[2] = {0, 0};  // loads into each buffer so far
  // per buffer and warp: the slots that warp must finish before the
  // buffer may be overwritten
  uint32_t need[2][MAX_WARPS];
  for (int v = 0; v < MAX_WARPS; ++v) need[0][v] = need[1][v] = 0;
  int cur = 0, w = 0, k = 0, qv = -1;
  for (int i = 0; i < n; ++i) {
    if ((i & 31) == 0) qv = i + lane < n ? q_ids[s0 + i + lane] : -1;
    const int q = __shfl_sync(0xFFFFFFFFu, qv, i & 31);
    if (k >= MAIL) wait_count(g.done + w, (uint32_t)(k - MAIL + 1), lane);   // entry free
    int b = cur;
    if (lq[cur] != q) {
      if (g.nl == 2 && lq[cur ^ 1] == q) {
        b = cur ^ 1;
      } else {
        b = (g.nl == 2 && lq[cur] != -1) ? cur ^ 1 : cur;
        for (int v = 0; v < g.W; ++v) wait_count(g.done + v, need[b][v], lane);
        g.copy(g.luts + (size_t)b * g.lb,
               reinterpret_cast<const unsigned char*>(luts + (size_t)q * (lut_bytes / 4)),
               lut_bytes, g.lutbar + 8 * b, lane);
        ++loads[b];
        lq[b] = q;
      }
    }
    cur = b;
    need[b][w] = (uint32_t)k + 1;
    if (lane == 0) {
      g.mail[MAIL * w + k % MAIL] = (uint32_t)b | (((loads[b] - 1) & 1) << 8);
      store_release(g.posted + w, (uint32_t)k + 1);
    }
    __syncwarp();
    if (++w == g.W) w = 0, ++k;
  }
}

}  // namespace adc_stage
