// K7 — gather-rescore of the TI/IVF probe's winner windows.
//
// Replaces vaq_tpu/ops/rescore_pallas.py: gather_rescore (:175) with its
// Pallas bodies _kernel (:105, K7) and _kernel_t (:39, K8, the transposed
// layout of d % 128 != 0; here one row-major layout serves every d that is a
// multiple of 16). For query i and each of its m winner windows w =
// wblk[i][j] (rows [w·gs, (w+1)·gs) of the flat buckets) it writes, for
// every row x of the window,
//     out[i][j][r] = 2·(q_i · x) − Σ_d w_d·x_d²  =  Σ_d x_d·(2·q_d − w_d·x_d)
// in f32, with q_i the bf16-rounded scale-folded query and x int8 or bf16.
// Each term is taken in the second form, two fused multiply-adds a value:
// 2·q_d − w_d·x_d rounds once, so a term is off by at most 2^-24 of
// |2·q_d·x_d| + w_d·x_d², the size of the terms the first form sums; the
// sums run in another order than the plain version's, as before. A window id
// outside [0, n_blk) gives NaN rather than a read out of bounds; dead slots
// are masked by the caller.
//
// What bounds it: the gathered bytes. At the 1M shapes (512 queries, m = 200
// windows of gs = 8 int8 rows, d = 128) that is 105 MB read and 3.3 MB
// written, about 0.03 ms at 3.35 TB/s, against 52 MFLOP. A window is gs
// consecutive rows, contiguous and 16-byte aligned (1 KB at that shape), so
// it moves as one unit, as the TPU kernel moved it by one async copy into a
// double-buffered slab:
//
// - The flat list of (query, window, chunk) items is cut into one
//   contiguous range a warp, over a persistent grid (as many blocks of 8
//   warps as fit; two an SM at the 1M shapes, for registers). A window
//   longer than CHUNK_BYTES or MAX_CHUNK_ROWS rows goes in chunks of whole
//   rows.
// - Each warp keeps its own ring of D slots in shared memory (D = 8 at 1 KB
//   chunks: 64 KB of windows in flight a block): lane 0 issues one
//   cp.async.bulk (the 1-D bulk copy, no tensor map) a chunk, its bytes
//   counted on the slot's mbarrier, and refills a slot with the item D
//   ahead as soon as the warp has scored it. An out-of-range id issues no
//   copy: lane 0 arrives on the barrier all the same, so the phase turns.
//   No warp ever waits on another, so no handshake between warps can hang
//   the card. (A producer warp feeding eight consumer warps through full
//   and empty barriers spent more time in the handshake than the bound.)
// - The warp's window ids come 32 items at a time, one coalesced load a
//   lane, the next 32 in flight; the lanes pass each item's id and place
//   by shuffles.
// - The lanes split into groups of G, each group a row, each lane fixed
//   16-byte vectors of it: G is as small as keeps a lane's vectors ≤ 4, so
//   one step covers a window's rows (G = 4 at d = 96 and 128: 8 rows a
//   step). A lane's 2·q and w for its columns stay in registers and reload
//   only when the item's query changes; all its loads of a row are issued
//   before any arithmetic, into four running sums. A row reduces over its
//   G lanes (2 shuffle steps at G = 4), the chunk's results gather into
//   lanes 0 … rows − 1 and leave as one coalesced store. G = 4 with one
//   column pass is compiled as a constant (0.068 → 0.058 ms at d = 128
//   int8 on an H100).
// - int8 converts by a byte permute and an add (exact, not the quarter-rate
//   I2F), bf16 by a shift.
//
// scripts/rescore_breakdown.py times it beside copies with the arithmetic
// or the copies cut, and beside the same ring filled by 16-byte cp.async
// (slower). At the 1M shapes the copies alone reach 2.7-2.9 TB/s; the
// arithmetic, about 300 instructions a chunk, takes longer still, and the
// two overlap. A ring slot holds at least one row and a warp at least two
// slots, so a row may not exceed (227 KB − 1 KB) / 16: d ≤ 14,400 int8 or
// 7,200 bf16; past that the launch reports cudaErrorInvalidValue.

#include <algorithm>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;                // a block; each warp works alone
constexpr int THREADS = 32 * WARPS;
constexpr int RING_BYTES = 64 * 1024;   // a block's slots, when chunks are small
constexpr int MAX_DEPTH = 16;           // slots a warp; ≤ 32 − 16 (the id batches below)
constexpr int CHUNK_BYTES = 8 * 1024;   // a longer window goes in chunks
constexpr int MAX_CHUNK_ROWS = 32;      // a chunk's results: one lane a row
constexpr int SMEM_LIMIT = 232448;      // 227 KB, the H100's per-block maximum
constexpr unsigned FULL = 0xffffffffu;

struct Geometry {
  int64_t n_blk;
  int m, gs, d;
  int row_bytes;   // d · sizeof(T), a multiple of 16
  int vpr;         // 16-byte vectors a row
  int lanes;       // G: lanes a row, a power of two ≤ 32
  int passes;      // column passes: vpr over lanes · VPL, rounded up
  int rpc;         // rows a chunk
  int cpw;         // chunks a window
  int depth;       // D: ring slots a warp
  int slot_bytes;  // rpc · row_bytes rounded up to 128
  int chunks;      // nq · m · cpw
};

__host__ __device__ constexpr int ring_offset() {
  return (WARPS * MAX_DEPTH * 8 + 127) / 128 * 128;  // the warps' mbarriers
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Byte J of xu, an int8 with its sign bit flipped, as f32, exactly, without
// the quarter-rate I2F: the byte is the low mantissa byte of 2^23 + (x + 128),
// and subtracting 2^23 + 128 leaves x.
template <int J>
__device__ __forceinline__ float s8_to_f32(uint32_t xu) {
  return __uint_as_float(__byte_perm(xu, 0x4B000000u, 0x7540 | J)) - 8388736.f;
}

// x·(2q − w·x) of one 16-byte vector into two running sums.
template <typename T>
__device__ __forceinline__ void accumulate(const uint4 v, const float* q2, const float* w,
                                           float& a0, float& a1) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
  if constexpr (sizeof(T) == 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t xu = u[k] ^ 0x80808080u;
      const float x0 = s8_to_f32<0>(xu), x1 = s8_to_f32<1>(xu);
      const float x2 = s8_to_f32<2>(xu), x3 = s8_to_f32<3>(xu);
      a0 = __fmaf_rn(x0, __fmaf_rn(-w[4 * k], x0, q2[4 * k]), a0);
      a1 = __fmaf_rn(x1, __fmaf_rn(-w[4 * k + 1], x1, q2[4 * k + 1]), a1);
      a0 = __fmaf_rn(x2, __fmaf_rn(-w[4 * k + 2], x2, q2[4 * k + 2]), a0);
      a1 = __fmaf_rn(x3, __fmaf_rn(-w[4 * k + 3], x3, q2[4 * k + 3]), a1);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float lo = __uint_as_float(u[k] << 16), hi = __uint_as_float(u[k] & 0xffff0000u);
      a0 = __fmaf_rn(lo, __fmaf_rn(-w[2 * k], lo, q2[2 * k]), a0);
      a1 = __fmaf_rn(hi, __fmaf_rn(-w[2 * k + 1], hi, q2[2 * k + 1]), a1);
    }
  }
}

// Where item i (a chunk of a window) comes from: its flat (query, window)
// index, its first row, and its window id.
struct Item {
  uint32_t win;
  int r0;
  int32_t wid;
};

__device__ __forceinline__ Item describe(const Geometry& g, const int32_t* __restrict__ wblk,
                                         int i, int end) {
  Item it{0, 0, -1};
  if (i < end) {
    it.win = static_cast<uint32_t>(i) / static_cast<uint32_t>(g.cpw);
    it.r0 = static_cast<int>(static_cast<uint32_t>(i) - it.win * g.cpw) * g.rpc;
    it.wid = __ldg(wblk + it.win);
  }
  return it;
}

__device__ __forceinline__ Item shfl_item(const Item& it, int src) {
  return Item{__shfl_sync(FULL, it.win, src), __shfl_sync(FULL, it.r0, src),
              __shfl_sync(FULL, it.wid, src)};
}

// VPL: vectors a lane holds of a row; GC: the lanes a row when fixed at
// compile time (4, with one column pass: the 1M shapes at d = 96 and 128),
// or 0 to read them from g.
template <typename T, int VPL, int GC>
__global__ void __launch_bounds__(THREADS)
gather_rescore_kernel(const __nv_bfloat16* __restrict__ q, const float* __restrict__ w,
                      const T* __restrict__ rows, const int32_t* __restrict__ wblk,
                      const Geometry g, float* __restrict__ out) {
  constexpr int E = 16 / sizeof(T);  // values a 16-byte vector
  extern __shared__ __align__(128) unsigned char sh[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int D = g.depth;
  uint64_t* full = reinterpret_cast<uint64_t*>(sh) + warp * MAX_DEPTH;
  unsigned char* ring = sh + ring_offset() + static_cast<size_t>(warp) * D * g.slot_bytes;
  const int64_t nw = static_cast<int64_t>(gridDim.x) * WARPS;
  const int64_t wg = static_cast<int64_t>(blockIdx.x) * WARPS + warp;
  const int lo = static_cast<int>(g.chunks * wg / nw);
  const int end = static_cast<int>(g.chunks * (wg + 1) / nw);
  if (lo >= end) return;
  if (lane == 0) {
    for (int s = 0; s < D; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();

  // Every lane calls this: lane 0 copies item `it` into slot s by one bulk
  // copy, or, for an out-of-range window id, arrives without a copy so that
  // the slot's phase still turns.
  auto issue = [&](const Item& it, int s) {
    if (lane != 0) return;
    if (it.wid >= 0 && it.wid < g.n_blk) {
      const uint32_t bytes = static_cast<uint32_t>(min(g.rpc, g.gs - it.r0) * g.row_bytes);
      mbar_arrive_tx(&full[s], bytes);
      bulk_copy(ring + static_cast<size_t>(s) * g.slot_bytes,
                reinterpret_cast<const unsigned char*>(rows) +
                    (static_cast<int64_t>(it.wid) * g.gs + it.r0) * g.row_bytes,
                bytes, &full[s]);
    } else {
      mbar_arrive(&full[s]);
    }
  };

  // Lane t holds item base + t (cur) and base + 32 + t (nxt); the next
  // batch's window ids load 32 − D items before they are needed.
  int base = lo;
  Item cur = describe(g, wblk, lo + lane, end);
  Item nxt = describe(g, wblk, lo + 32 + lane, end);
  for (int k = 0; k < D && lo + k < end; ++k) issue(shfl_item(cur, k), k);

  // Lane gl of row group rl reads vectors gl, gl + G, … of its row.
  const int G = GC ? GC : g.lanes, R = 32 / G;
  const int passes = GC ? 1 : g.passes;
  const int gl = lane & (G - 1), rl = lane / G;
  float q2[VPL * E], wv[VPL * E];
  auto load_w = [&](int p) {
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int vec = (p * VPL + v) * G + gl;
#pragma unroll
      for (int e = 0; e < E; ++e) wv[v * E + e] = vec < g.vpr ? __ldg(w + vec * E + e) : 0.f;
    }
  };
  auto load_q = [&](int qi, int p) {
    const __nv_bfloat16* qr = q + static_cast<int64_t>(qi) * g.d;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int vec = (p * VPL + v) * G + gl;
#pragma unroll
      for (int e = 0; e < E; ++e)
        q2[v * E + e] = vec < g.vpr ? 2.f * __bfloat162float(qr[vec * E + e]) : 0.f;
    }
  };
  const bool one_pass = passes == 1;
  if (one_pass) load_w(0);
  // The query whose 2q the registers hold, and its windows' flat range.
  int held = -1;
  uint32_t held_lo = 1, held_hi = 0;
  int s = 0;
  uint32_t phase = 0;
  for (int i = lo; i < end; ++i) {
    const Item it = shfl_item(cur, i - base);
    const int nr = min(g.rpc, g.gs - it.r0);
    if (it.win < held_lo || it.win >= held_hi) {  // a new query: a division, rarely
      held = static_cast<int>(it.win / static_cast<uint32_t>(g.m));
      held_lo = static_cast<uint32_t>(held) * g.m;
      held_hi = held_lo + g.m;
      if (one_pass) load_q(held, 0);  // before the wait: the loads overlap it
    }
    const int qi = held;
    mbar_wait(&full[s], phase);
    float mine = NAN;
    if (it.wid >= 0 && it.wid < g.n_blk) {
      const unsigned char* slot = ring + static_cast<size_t>(s) * g.slot_bytes;
      for (int rb = 0; rb < nr; rb += R) {
        const int r = rb + rl;
        float a[4] = {0.f, 0.f, 0.f, 0.f};  // two sums a vector, vectors in turn
        if (r < nr) {
          const unsigned char* row = slot + r * g.row_bytes;
          for (int p = 0; p < passes; ++p) {
            if (!one_pass) {
              load_w(p);
              load_q(qi, p);
            }
            uint4 x[VPL];  // every load of the row in flight before any arithmetic
#pragma unroll
            for (int v = 0; v < VPL; ++v) {
              const int vec = (p * VPL + v) * G + gl;
              if (vec < g.vpr) x[v] = *reinterpret_cast<const uint4*>(row + vec * 16);
            }
#pragma unroll
            for (int v = 0; v < VPL; ++v)
              if ((p * VPL + v) * G + gl < g.vpr)
                accumulate<T>(x[v], q2 + v * E, wv + v * E, a[2 * (v & 1)], a[2 * (v & 1) + 1]);
          }
        }
        float acc = (a[0] + a[1]) + (a[2] + a[3]);
#pragma unroll
        for (int off = G / 2; off > 0; off /= 2) acc += __shfl_xor_sync(FULL, acc, off);
        // row rb + t's sum, from its group, to lane rb + t
        const float got = __shfl_sync(FULL, acc, (lane & (R - 1)) * G);
        if ((lane & ~(R - 1)) == rb) mine = got;
      }
    }
    // Refill the slot with item i + D. Every lane's reads of it have
    // returned by now (their sums went through the shuffles above), so the
    // copy cannot overwrite a value still to be read.
    const int nk = i + D - base;  // < 64: D ≤ 16 and i − base < 32
    const Item nx = nk < 32 ? shfl_item(cur, nk) : shfl_item(nxt, nk - 32);
    __syncwarp();
    if (i + D < end) issue(nx, s);
    if (lane < nr) out[static_cast<int64_t>(it.win) * g.gs + it.r0 + lane] = mine;
    if (++s == D) {
      s = 0;
      phase ^= 1;
    }
    if (i + 1 - base == 32) {
      base += 32;
      cur = nxt;
      nxt = describe(g, wblk, base + 32 + lane, end);
    }
  }
}

template <typename T, int VPL, int GC>
int launch(const void* q, const void* w, const void* rows, const void* wblk, const Geometry& g,
           void* out, cudaStream_t st) {
  auto kernel = gather_rescore_kernel<T, VPL, GC>;
  const int smem = ring_offset() + WARPS * g.depth * g.slot_bytes;
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  // The opt-in above 48 KB and the occupancy query cost more host time
  // than a launch: each is made again only when the device or the
  // shared-memory size changes (a launch refused for want of either still
  // reports its error to the caller).
  static int last_dev = -1, last_smem = -1, per_sm = 1;
  if (dev != last_dev || smem != last_smem) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    last_dev = dev;
    last_smem = smem;
  }
  const int64_t warps_needed = (g.chunks + 15) / 16;  // at least 16 items a warp
  const int grid = static_cast<int>(std::max<int64_t>(
      1, std::min<int64_t>((warps_needed + WARPS - 1) / WARPS,
                           static_cast<int64_t>(std::max(n_sm, 1)) * std::max(per_sm, 1))));
  kernel<<<grid, THREADS, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(w),
      static_cast<const T*>(rows), static_cast<const int32_t*>(wblk), g,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_vpl(int vpl, const void* q, const void* w, const void* rows, const void* wblk,
               const Geometry& g, void* out, cudaStream_t st) {
  if (g.lanes == 4 && g.passes == 1) {
    if (vpl == 1) return launch<T, 1, 4>(q, w, rows, wblk, g, out, st);
    if (vpl == 2) return launch<T, 2, 4>(q, w, rows, wblk, g, out, st);
    return launch<T, 4, 4>(q, w, rows, wblk, g, out, st);
  }
  if (vpl == 1) return launch<T, 1, 0>(q, w, rows, wblk, g, out, st);
  if (vpl == 2) return launch<T, 2, 0>(q, w, rows, wblk, g, out, st);
  return launch<T, 4, 0>(q, w, rows, wblk, g, out, st);
}

}  // namespace

extern "C" {

// q (nq, d) bf16; w (d,) f32; rows (n_blk·gs, d) int8 (rows_int8 != 0) or
// bf16, 16-byte aligned; wblk (nq, m) int32; out (nq, m, gs) f32. Needs
// d % 16 == 0 (the wrapper checks). Launches on `stream`, allocates nothing,
// does not synchronise; returns cudaGetLastError(), or cudaErrorInvalidValue
// for a row too long for the ring or more chunks than an int counts.
int vaq_gather_rescore(const void* q, const void* w, const void* rows, int rows_int8,
                       int64_t n_blk, const void* wblk, int nq, int m, int gs,
                       int d, void* out, void* stream) {
  Geometry g{};
  g.n_blk = n_blk;
  g.m = m;
  g.gs = gs;
  g.d = d;
  g.row_bytes = d * (rows_int8 ? 1 : 2);
  g.vpr = g.row_bytes / 16;
  g.rpc = std::max(1, std::min({gs, MAX_CHUNK_ROWS, CHUNK_BYTES / std::max(g.row_bytes, 1)}));
  // Lanes a row: few enough that one step covers a chunk's rows, but at
  // least enough that a lane holds at most four of a row's vectors (past 32
  // lanes, column passes), and no more than the row has vectors.
  auto pow2_at_least = [](int x) {
    int p = 1;
    while (p < x) p *= 2;
    return p;
  };
  g.lanes = std::min({32, pow2_at_least(g.vpr),
                      std::max(32 / pow2_at_least(g.rpc), pow2_at_least((g.vpr + 3) / 4))});
  const int need = (g.vpr + g.lanes - 1) / g.lanes;  // vectors a lane
  const int vpl = need <= 1 ? 1 : need <= 2 ? 2 : 4;
  g.passes = (need + vpl - 1) / vpl;
  g.cpw = (gs + g.rpc - 1) / g.rpc;
  g.slot_bytes = (g.rpc * g.row_bytes + 127) / 128 * 128;
  g.depth = std::max(2, std::min(MAX_DEPTH, RING_BYTES / WARPS / g.slot_bytes));
  const int64_t chunks = static_cast<int64_t>(nq) * m * g.cpw;
  if (chunks == 0) return static_cast<int>(cudaGetLastError());
  if (chunks > INT32_MAX - 64 ||
      static_cast<int64_t>(ring_offset()) + static_cast<int64_t>(WARPS) * g.depth * g.slot_bytes >
          SMEM_LIMIT)
    return static_cast<int>(cudaErrorInvalidValue);
  g.chunks = static_cast<int>(chunks);
  const auto st = static_cast<cudaStream_t>(stream);
  return rows_int8 ? launch_vpl<int8_t>(vpl, q, w, rows, wblk, g, out, st)
                   : launch_vpl<__nv_bfloat16>(vpl, q, w, rows, wblk, g, out, st);
}

}  // extern "C"
