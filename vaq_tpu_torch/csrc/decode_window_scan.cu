// K1 — decode-then-dot window scan, the codes-resident tier's scan.
//
// Replaces vaq_tpu/ops/scan_pallas.py: decode_window_scan (:363) and its
// Pallas body _decode_score_kernel (:283). For every (query q, window of
// block_rows rows) it returns the window's smallest
//     dist = (‖x̂‖² − 2·q·x̂) + ‖q‖²,   clamped at +0,
// rounded step by step in that order, packed with the row into one int32
// key: the f32 bits of dist with the low idx_bits replaced by the row's
// index inside its window. Non-negative f32 bits order like the floats, so
// the min key is the min distance, ties going to the lower row, exactly as
// the JAX kernel packs it (scan_pallas.py:352-358). x̂ is decoded from u8
// codes through the bf16-rounded decode table; q is bf16; the dot runs on
// those bf16 values with f32 sums, and ‖x̂‖² is summed in f32 from the same
// bf16 values. Rows at or past n_rows decode as code 0, which is what the
// JAX caller's zero padding of the codes gives; rows at or past n_win ·
// block_rows do not exist.
//
// What bounds it: 2·nq·n·d operations — 2·512·1M·128 ≈ 134 GFLOP per
// 512-query batch at n = 1M, d = 128, 0.136 ms in bf16 at the H100 SXM's
// 989 TFLOP/s — against 32 MB of codes read (0.010 ms at 3.35 TB/s). It is
// compute-bound, so the product runs on the tensor cores, and the design
// keeps the decode and the window minimum out of their way:
//
// - One resident block per SM walks over 128-row tiles of the codes,
//   grid-stride, with its query chunk (all 512 queries of a batch at
//   d = 128, 136 KB of bf16) staged in shared memory once.
// - Four producer warps decode the next tile while eight consumer warps
//   multiply the current one: two decoded buffers, handed over by named
//   barriers (full / empty). The producers copy a tile's codes in with
//   cp.async one tile ahead, and decode 8 rows at a time (one warp a row,
//   each lane four columns of a subspace, or two), the table lookups of
//   those rows issued together; ‖x̂‖² is summed in f32 from the same bf16
//   values and reduced by shuffles. Decoding is exact (the table is bf16).
//   The table (64 KB at C = 256, d = 128) sits in shared memory where it
//   fits beside the chunk, else it is read through the read-only cache.
// - Each consumer warp owns 64 rows × 32 queries of a 128-query sub-tile:
//   4 × 4 mma.sync.m16n8k16 bf16 → f32 tiles per 16-deep step, fed by
//   ldmatrix, the next step's fragments loaded before this step's products.
//   Staged rows are the depth rounded up to 16 plus 8 bf16 of padding (a
//   stride of 4 banks mod 32), so each ldmatrix phase of 8 rows × 16 B
//   touches all 32 banks once; the depth padding holds zeros in both
//   operands (shared memory that was never written may hold NaN bits, and
//   NaN × 0 is NaN).
// - The window minimum is taken in the epilogue, from the accumulators:
//   dist, its clamp and the packed key for each (row, query) a thread holds,
//   the min over its 8 rows, then — where block_rows is a multiple of 64, so
//   a warp's rows lie in one window — a reduce-scatter over the 8 lanes that
//   hold the other rows (7 shuffles leave each lane one query's minimum).
//   A 64-row window is then stored by its warp, a 128-row window (the tile)
//   by one warp of the pair after a pair barrier, longer windows by
//   atomicMin; nothing waits on the whole block. Other block_rows (1, 16,
//   24, …) take each row's window from its global index and meet in global
//   memory by atomicMin.
// - A depth too large for one sub-tile's staging (d = 512 at M = 512) goes
//   in slices, the query slices double-buffered by the producers too.
//
// ptxas (sm_90a, the .log beside the built library): 149-152 registers,
// 0 bytes spilled.
//
// The TPU kernel's bf16-pair packed table, lane-replication matmul and
// (8, 128) tiling were Mosaic workarounds and have no counterpart here.

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TR = 128;       // rows per tile
constexpr int QT = 128;       // queries per sub-tile
constexpr int WARPS_M = 2;    // consumer warps along the rows, 64 rows each
constexpr int WARPS_N = 4;    // consumer warps along the queries, 32 each
constexpr int CONSUMERS = 32 * WARPS_M * WARPS_N;
constexpr int PRODUCER_WARPS = 4;
constexpr int THREADS = CONSUMERS + 32 * PRODUCER_WARPS;
constexpr int PAD = 8;        // bf16 of padding after each staged row
constexpr int ROWS_AT_ONCE = 8;  // rows a producer warp decodes together
// named barriers (0 is __syncthreads): a decoded buffer is full / empty,
// the producers among themselves, the two row warps of a query slice
// (BAR_PAIR + wn)
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_PRODUCERS = 5, BAR_PAIR = 6;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 16-deep step's operands of a consumer warp: 4 row tiles of 16 (A) and
// 4 query tiles of 8 (B, two per ldmatrix).
struct Frags {
  uint32_t a[4][4], b[2][4];
};

__device__ __forceinline__ void load_frags(Frags& f, const __nv_bfloat16* pa,
                                           const __nv_bfloat16* pb, int sx, int k0) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) ldmatrix_x4(f.a[mt], pa + mt * 16 * sx + k0);
  ldmatrix_x4(f.b[0], pb + k0);
  ldmatrix_x4(f.b[1], pb + 16 * sx + k0);
}

__device__ __forceinline__ void mma_frags(float (&acc)[4][4][4], const Frags& f) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      mma_bf16(acc[mt][nt], f.a[mt], f.b[nt >> 1][(nt & 1) * 2],
               f.b[nt >> 1][(nt & 1) * 2 + 1]);
}

// acc += the warp's 64 rows × 32 queries over kcur (a multiple of 16) of
// depth. Two fragment sets: the next step's loads go out before this step's
// products. STEPS > 0: kcur = 16·STEPS, fully unrolled (the main path's
// d = 128).
template <int STEPS>
__device__ __forceinline__ void mma_depth(float (&acc)[4][4][4], const __nv_bfloat16* pa,
                                          const __nv_bfloat16* pb, int sx, int kcur) {
  Frags f[2];
  load_frags(f[0], pa, pb, sx, 0);
  if (STEPS > 0) {
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
      if (k + 1 < STEPS) load_frags(f[(k + 1) & 1], pa, pb, sx, 16 * (k + 1));
      mma_frags(acc, f[k & 1]);
    }
    return;
  }
  for (int k0 = 0; k0 < kcur; k0 += 32) {
    const bool two = k0 + 16 < kcur;
    if (two) load_frags(f[1], pa, pb, sx, k0 + 16);
    mma_frags(acc, f[0]);
    if (two) {
      if (k0 + 32 < kcur) load_frags(f[0], pa, pb, sx, k0 + 32);
      mma_frags(acc, f[1]);
    }
  }
}

// Two bf16 table values at p (4-byte aligned), from shared memory or, through
// the read-only cache, from global memory.
template <bool TABLE_SMEM>
__device__ __forceinline__ __nv_bfloat162 load_pair(const __nv_bfloat16* p) {
  if (TABLE_SMEM) return *reinterpret_cast<const __nv_bfloat162*>(p);
  const uint32_t bits = __ldg(reinterpret_cast<const unsigned int*>(p));
  return *reinterpret_cast<const __nv_bfloat162*>(&bits);
}

// Four bf16 table values at p (8-byte aligned), likewise.
template <bool TABLE_SMEM>
__device__ __forceinline__ uint2 load_quad(const __nv_bfloat16* p) {
  if (TABLE_SMEM) return *reinterpret_cast<const uint2*>(p);
  return __ldg(reinterpret_cast<const uint2*>(p));
}

// The codes of tile `tile` (TR rows of m bytes) into dst, rows at or past
// n_rows as code 0, by the producer threads (pt of np): 16-byte cp.async
// copies that land while the previous tile is decoded, or plain byte loads
// where the codes are not 16-byte aligned.
__device__ __forceinline__ void fetch_codes(uint8_t* dst, const uint8_t* codes,
                                            int64_t tile, int64_t n_rows, int m,
                                            bool aligned, int pt, int np) {
  const int64_t r0 = tile * TR;
  const int64_t left = n_rows - r0;
  const int64_t valid = (left <= 0 ? 0 : left < TR ? left : TR) * m;
  const uint8_t* src = codes + r0 * m;
  if (aligned) {
    for (int i = pt; i < TR * m / 16; i += np) {
      const int64_t have = valid - 16 * static_cast<int64_t>(i);
      const int bytes = have <= 0 ? 0 : have < 16 ? static_cast<int>(have) : 16;
      const uint32_t d_s = static_cast<uint32_t>(__cvta_generic_to_shared(dst + 16 * i));
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d_s),
                   "l"(bytes ? src + 16 * i : codes), "r"(bytes));
    }
  } else {
    for (int i = pt; i < TR * m; i += np) dst[i] = i < valid ? src[i] : 0;
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// WARP_WIN: block_rows % 64 == 0, so the 64 rows of a consumer warp share a
// window. TABLE_SMEM: the decode table is staged in shared memory.
template <bool WARP_WIN, bool TABLE_SMEM>
__global__ void __launch_bounds__(THREADS, 1)
decode_window_scan_kernel(const uint8_t* __restrict__ codes, int64_t n_rows,
                          int64_t n_total, int m, int c,
                          const __nv_bfloat16* __restrict__ table,
                          const __nv_bfloat16* __restrict__ q,
                          const float* __restrict__ qn, int nq, int d, int l,
                          int dpad, int block_rows, int idx_bits,
                          int q_chunk, int kc, int64_t n_win,
                          int32_t* __restrict__ keys) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool sliced = kc < dpad;  // then q_chunk == QT
  const int sx = kc + PAD;        // staged row stride in bf16
  const int q_rows = sliced ? 2 * QT : q_chunk;
  const int tbl_elems = TABLE_SMEM ? (c * d + 7) / 8 * 8 : 0;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][TR][sx]
  __nv_bfloat16* qs = xs + 2 * TR * sx;  // [q_chunk][sx], sliced: [2][QT][sx]
  __nv_bfloat16* table_s = qs + q_rows * sx;                  // [c·d]
  float* norm_s = reinterpret_cast<float*>(table_s + tbl_elems);  // [2][TR]
  float* norm_acc = norm_s + 2 * TR;     // [TR], the producers' running sums
  float* qn_s = norm_acc + TR;                                // [q_chunk]
  int32_t* pair = reinterpret_cast<int32_t*>(qn_s + q_chunk);  // [2][WARPS_N][32]
  uint8_t* codes_s = reinterpret_cast<uint8_t*>(pair + 2 * WARPS_N * 32);  // [2][TR·m]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * q_chunk;
  const int nqc = min(q_chunk, nq - q0);
  const int64_t n_tiles = (n_total + TR - 1) / TR;
  const int n_slices = (dpad + kc - 1) / kc;

  // Stage queries [q0 + qa, q0 + qa + nrows) × columns [k_lo, k_lo + kcur)
  // into dst by the threads [t0, t0 + nt), zero past d and past nq.
  auto stage_q = [&](__nv_bfloat16* dst, int qa, int nrows, int k_lo, int kcur,
                     int t0, int nt) {
    for (int i = tid - t0; i < nrows * kcur; i += nt) {
      const int qq = i / kcur, col = k_lo + i % kcur;
      dst[qq * sx + col - k_lo] =
          (qa + qq < nqc && col < d)
              ? q[static_cast<int64_t>(q0 + qa + qq) * d + col]
              : __float2bfloat16_rn(0.f);
    }
  };
  if (!sliced) stage_q(qs, 0, q_chunk, 0, dpad, 0, THREADS);
  for (int i = tid; i < q_chunk; i += THREADS) qn_s[i] = i < nqc ? qn[q0 + i] : 0.f;
  if (TABLE_SMEM) {
    if ((reinterpret_cast<uintptr_t>(table) & 15) == 0 && (c * d) % 8 == 0) {
      for (int i = tid; i < c * d / 8; i += THREADS)
        reinterpret_cast<uint4*>(table_s)[i] = __ldg(reinterpret_cast<const uint4*>(table) + i);
    } else {
      for (int i = tid; i < c * d; i += THREADS) table_s[i] = table[i];
    }
  }
  __syncthreads();
  const __nv_bfloat16* tbl = TABLE_SMEM ? table_s : table;

  if (tid >= CONSUMERS) {
    // ---- Producers: decode (tile, depth slice) units into the two
    // buffers, in the order the consumers take them. A tile's codes are
    // copied in while the tile before it is decoded.
    const int pw = warp - CONSUMERS / 32;
    const int pt = tid - CONSUMERS, np = THREADS - CONSUMERS;
    const bool aligned = (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
    int u = 0, k = 0;
    fetch_codes(codes_s, codes, blockIdx.x, n_rows, m, aligned, pt, np);
    for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++k) {
      const uint8_t* cb = codes_s + (k & 1) * TR * m;
      bar_sync(BAR_PRODUCERS, np);  // the tile before is decoded: its buffer is free
      fetch_codes(codes_s + ((k + 1) & 1) * TR * m, codes, tile + gridDim.x,
                  n_rows, m, aligned, pt, np);
      asm volatile("cp.async.wait_group 1;\n" ::);
      bar_sync(BAR_PRODUCERS, np);  // this tile's codes have landed
      for (int sl = 0; sl < n_slices; ++sl, ++u) {
        const int b = u & 1;
        const int k_lo = sl * kc, kcur = min(kc, dpad - k_lo);
        if (u >= 2) bar_sync(BAR_EMPTY + b, THREADS);
        __nv_bfloat16* xb = xs + b * TR * sx;
        if (sliced)
          stage_q(qs + b * QT * sx, 0, QT, k_lo, kcur, CONSUMERS, THREADS - CONSUMERS);
        // one warp a row, each lane two columns, ROWS_AT_ONCE rows at once
        // so that their loads overlap
        const int n_it = (kcur / 2 + 31) / 32;  // column pairs per lane
        for (int r = pw; r < TR; r += ROWS_AT_ONCE * PRODUCER_WARPS) {
          float part[ROWS_AT_ONCE];
#pragma unroll
          for (int i = 0; i < ROWS_AT_ONCE; ++i) part[i] = 0.f;
          if ((l & 3) == 0) {
            // four columns of one subspace a lane: 8-byte loads and stores
            for (int it = 0; 4 * (lane + 32 * it) < kcur; ++it) {
              const int c0 = k_lo + 4 * (lane + 32 * it);
              uint2 v[ROWS_AT_ONCE];
              if (c0 >= d) {
#pragma unroll
                for (int i = 0; i < ROWS_AT_ONCE; ++i) v[i] = make_uint2(0u, 0u);
              } else {
                const int sub = c0 / l;
                int code[ROWS_AT_ONCE];
#pragma unroll
                for (int i = 0; i < ROWS_AT_ONCE; ++i)
                  code[i] = cb[(r + i * PRODUCER_WARPS) * m + sub];
#pragma unroll
                for (int i = 0; i < ROWS_AT_ONCE; ++i)
                  v[i] = load_quad<TABLE_SMEM>(tbl + code[i] * d + c0);
              }
#pragma unroll
              for (int i = 0; i < ROWS_AT_ONCE; ++i) {
                *reinterpret_cast<uint2*>(&xb[(r + i * PRODUCER_WARPS) * sx + c0 - k_lo]) = v[i];
                const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v[i].x));
                const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v[i].y));
                part[i] = __fmaf_rn(hi.y, hi.y, __fmaf_rn(hi.x, hi.x,
                          __fmaf_rn(lo.y, lo.y, __fmaf_rn(lo.x, lo.x, part[i]))));
              }
            }
          } else {
            for (int it = 0; it < n_it; ++it) {
              const int c0 = k_lo + 2 * (lane + 32 * it);
              if (c0 >= k_lo + kcur) break;
              // the branches stay outside the loops over rows, so that the
              // rows' loads go out together
              __nv_bfloat162 v[ROWS_AT_ONCE];
              if (c0 >= d) {
#pragma unroll
                for (int i = 0; i < ROWS_AT_ONCE; ++i) v[i] = __floats2bfloat162_rn(0.f, 0.f);
              } else if ((l & 1) == 0) {  // both columns in one subspace
                const int sub = c0 / l;
                int code[ROWS_AT_ONCE];
#pragma unroll
                for (int i = 0; i < ROWS_AT_ONCE; ++i) code[i] = cb[(r + i * PRODUCER_WARPS) * m + sub];
#pragma unroll
                for (int i = 0; i < ROWS_AT_ONCE; ++i)
                  v[i] = load_pair<TABLE_SMEM>(tbl + code[i] * d + c0);
              } else {
#pragma unroll
                for (int i = 0; i < ROWS_AT_ONCE; ++i) {
                  const uint8_t* crow = cb + (r + i * PRODUCER_WARPS) * m;
                  v[i].x = tbl[crow[c0 / l] * d + c0];
                  v[i].y = c0 + 1 < d ? tbl[crow[(c0 + 1) / l] * d + c0 + 1]
                                      : __float2bfloat16_rn(0.f);
                }
              }
#pragma unroll
              for (int i = 0; i < ROWS_AT_ONCE; ++i) {
                *reinterpret_cast<__nv_bfloat162*>(
                    &xb[(r + i * PRODUCER_WARPS) * sx + c0 - k_lo]) = v[i];
                const float f0 = __low2float(v[i]), f1 = __high2float(v[i]);
                part[i] = __fmaf_rn(f1, f1, __fmaf_rn(f0, f0, part[i]));
              }
            }
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
#pragma unroll
            for (int i = 0; i < ROWS_AT_ONCE; ++i)
              part[i] += __shfl_xor_sync(0xffffffffu, part[i], o);
          if (lane < ROWS_AT_ONCE) {
            float mine = part[0];
#pragma unroll
            for (int i = 1; i < ROWS_AT_ONCE; ++i) mine = lane == i ? part[i] : mine;
            const int rr = r + lane * PRODUCER_WARPS;
            // ‖x̂‖² over the slices so far; the last slice's buffer holds it
            const float sum = sl == 0 ? mine : norm_acc[rr] + mine;
            norm_acc[rr] = sum;
            norm_s[b * TR + rr] = sum;
          }
        }
        bar_arrive(BAR_FULL + b, THREADS);
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    // take the consumers' last releases, so that no barrier is left open
    for (int v = max(u - 2, 0); v < u; ++v) bar_sync(BAR_EMPTY + (v & 1), THREADS);
    return;
  }

  // ---- Consumers: products on the tensor cores, the epilogue, the writes.
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;
  const int32_t idx_mask = (1 << idx_bits) - 1;
  int buf = 0;  // the half of `pair` this sub-tile uses
  int u = 0;    // units consumed
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t r0 = tile * TR;
    const int64_t w0 = r0 / block_rows;

    // This thread's 8 rows: r = wm·64 + mt·16 + h·8 + g, in increasing order.
    int32_t rloc[4][2];   // row inside its window, or -1 past n_total
    int wl[4][2];         // window − w0
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t row = r0 + wm * 64 + mt * 16 + h * 8 + g;
        const int64_t w = row / block_rows;
        rloc[mt][h] = row < n_total ? static_cast<int32_t>(row - w * block_rows) : -1;
        wl[mt][h] = static_cast<int>(w - w0);
      }

    for (int qs0 = 0; qs0 < nqc; qs0 += QT) {
      float acc[4][4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

      // The depth: one slice (decoded once per tile) unless d is too deep
      // for the shared memory.
      for (int sl = 0; sl < n_slices; ++sl) {
        const int b = u & 1;
        const int kcur = min(kc, dpad - sl * kc);
        if (sliced || qs0 == 0) bar_sync(BAR_FULL + b, THREADS);
        // ldmatrix addresses: A rows (lane % 16), column half (lane / 16);
        // B queries (lane % 8) + 8·(lane / 16), column half ((lane / 8) % 2)
        const __nv_bfloat16* pa =
            xs + b * TR * sx + (wm * 64 + (lane & 15)) * sx + (lane >> 4) * 8;
        const __nv_bfloat16* pb = (sliced ? qs + b * QT * sx : qs + qs0 * sx) +
                                  (wn * 32 + (lane & 7) + (lane >> 4) * 8) * sx +
                                  ((lane >> 3) & 1) * 8;
        if (kcur == 128) mma_depth<8>(acc, pa, pb, sx, kcur);
        else mma_depth<0>(acc, pa, pb, sx, kcur);
        if (sliced && sl + 1 < n_slices) {
          bar_arrive(BAR_EMPTY + b, THREADS);  // this slice's buffer is read
          ++u;
        }
      }
      const int b = u & 1;  // the buffer of the tile's (last) slice

      // Epilogue: dist and key for each (row, query) held, the window min.
      float nrm[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) nrm[mt][h] = norm_s[b * TR + wm * 64 + mt * 16 + h * 8 + g];
      int32_t best[8];      // per column j = nt·2 + e
      int32_t* qkeys = keys + static_cast<int64_t>(q0 + qs0) * n_win;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ql = wn * 32 + nt * 8 + 2 * t + e;  // in the sub-tile
          const bool qok = qs0 + ql < nqc;
          const float qv = qn_s[qs0 + ql];
          int32_t bst = INT_MAX;
          int bw = -1;
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              // a warp's rows are all valid or all past n_total where its
              // window is whole (the result is then dropped): no test there
              if (!WARP_WIN && rloc[mt][h] < 0) continue;
              // (‖x̂‖² − 2·dot) + ‖q‖²: 2·dot is exact, so the fma rounds
              // as the subtraction does
              const float dist =
                  __fadd_rn(__fmaf_rn(-2.f, acc[mt][nt][h * 2 + e], nrm[mt][h]), qv);
              // clamp at +0 on the bits: negative floats (and −0) are
              // negative ints
              const int32_t bits = max(__float_as_int(dist), 0);
              const int32_t key = (bits & ~idx_mask) | rloc[mt][h];
              if (WARP_WIN) {
                bst = min(bst, key);
              } else if (wl[mt][h] != bw) {
                if (bw >= 0 && qok) atomicMin(qkeys + ql * n_win + w0 + bw, bst);
                bw = wl[mt][h];
                bst = key;
              } else {
                bst = min(bst, key);
              }
            }
          if (WARP_WIN) best[nt * 2 + e] = bst;
          else if (bw >= 0 && qok) atomicMin(qkeys + ql * n_win + w0 + bw, bst);
        }
      if (WARP_WIN) {
        // The warp's 64 rows are one window. The 8 lanes of a column group
        // (same t) hold 8 columns each for other rows: reduce and scatter,
        // halving the columns a lane keeps at each step, so that lane g ends
        // with column g's min over all 64 rows (7 shuffles, not 24).
        const bool b2 = lane & 16, b1 = lane & 8, b0 = lane & 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int32_t other = __shfl_xor_sync(0xffffffffu, b2 ? best[i] : best[i + 4], 16);
          best[i] = min(b2 ? best[i + 4] : best[i], other);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int32_t other = __shfl_xor_sync(0xffffffffu, b1 ? best[i] : best[i + 2], 8);
          best[i] = min(b1 ? best[i + 2] : best[i], other);
        }
        const int32_t other = __shfl_xor_sync(0xffffffffu, b0 ? best[0] : best[1], 4);
        const int32_t v = min(b0 ? best[1] : best[0], other);
        // lane g holds column j = g: nt = g / 2, e = g % 2
        const int ql = wn * 32 + (g >> 1) * 8 + 2 * t + (g & 1);
        // rows at or past n_total come in whole warps (n_total is a multiple
        // of block_rows), so rloc[0][0] speaks for the warp
        const bool ok = rloc[0][0] >= 0 && qs0 + ql < nqc;
        int32_t* out = qkeys + ql * n_win + w0 + wl[0][0];
        if (block_rows == 64) {
          if (ok) *out = v;  // the warp's rows are the whole window
        } else if (block_rows == 128) {
          // the tile is the window: the row-warp pair (wm = 0, 1) of these
          // columns meets in shared memory, then wm = 0 stores
          int32_t* slot = pair + ((buf * WARPS_N + wn) << 5) + lane;
          if (wm == 1) *slot = v;
          bar_sync(BAR_PAIR + wn, 64);
          if (wm == 0 && ok) *out = min(v, *slot);
        } else if (ok) {
          atomicMin(out, v);  // the window spans tiles
        }
      }
      if (qs0 + QT >= nqc) {
        bar_arrive(BAR_EMPTY + b, THREADS);  // the tile's buffer is read
        ++u;
      }
      buf ^= 1;
    }
  }
}

}  // namespace

extern "C" {

// codes (n_rows, m) u8; table (c, d) bf16; q (nq, d) bf16; qn (nq,) f32;
// keys (nq, n_win) int32 must hold INT_MAX on entry. q_chunk (queries a
// block stages, a multiple of 128), kc (the depth staged at once, a multiple
// of 16: the depth rounded up to 16, or less with q_chunk = 128 where that
// does not fit), table_smem (stage the table in shared memory) and smem (the
// block's dynamic shared memory) come from the wrapper (ops/scan_codes.py,
// _k1_tile). Launches on `stream`, allocates nothing, does not synchronise;
// returns cudaGetLastError().
int vaq_decode_window_scan(const void* codes, int64_t n_rows, int m, int c,
                           const void* table, const void* q, const void* qn,
                           int nq, int d, int block_rows, int idx_bits,
                           int64_t n_win, int q_chunk, int kc, int table_smem,
                           int smem, void* keys, void* stream) {
  const int64_t n_total = n_win * block_rows;
  const int dpad = (d + 15) / 16 * 16;
  const bool warp_win = block_rows % 64 == 0;
  auto kernel = warp_win ? (table_smem ? decode_window_scan_kernel<true, true>
                                       : decode_window_scan_kernel<true, false>)
                         : (table_smem ? decode_window_scan_kernel<false, true>
                                       : decode_window_scan_kernel<false, false>);
  // Above 48 KB a launch is refused unless the kernel opted in; the caller
  // checks the returned error, so a refusal is never silent.
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, n_sm = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  const int64_t n_tiles = (n_total + TR - 1) / TR;
  const int64_t resident = static_cast<int64_t>(n_sm) * std::max(per_sm, 1);
  const dim3 grid(static_cast<unsigned>(std::min(n_tiles, resident)),
                  static_cast<unsigned>((nq + q_chunk - 1) / q_chunk));
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), n_rows, n_total, m, c,
      static_cast<const __nv_bfloat16*>(table),
      static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(qn), nq,
      d, d / m, dpad, block_rows, idx_bits, q_chunk, kc, n_win,
      static_cast<int32_t*>(keys));
  return static_cast<int>(cudaGetLastError());
}

const char* vaq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
