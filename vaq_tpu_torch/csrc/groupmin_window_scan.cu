// K5 — group-min window scan of the TI/IVF cluster probe.
//
// Replaces vaq_tpu/ops/probe_pallas.py: groupmin_window_scan (:249) with its
// Pallas bodies _groupmin_kernel (:158, K5) and _groupmin_kernel_t (:205,
// K6, the same computation over the TPU's transposed layout for d % 128 != 0;
// here one row-major layout serves every d that is a multiple of 16). For
// every cluster c, query slot s of c's dispatched queries and gs-row group g
// of c's bucket it writes
//     out[c][s][g] = min over the group's rows x of ((qsl·x) + xn) + qn,
//     xn = Σ_d w_d·x_d²,  qn = 0.25·Σ_d qsl_d²,
// in f32, rounded step by step in that order, where qsl is the slot's bf16
// query, already scaled by −2 (and by the per-dim int8 scales for int8 rows)
// and x the stored row, int8 or bf16. qn is the norm of that bf16 slab, as in
// the JAX kernel; the minima only rank windows, and must rank them as JAX
// does. int8 values (the ±127 poison rows too) are exact in bf16, and bf16 ×
// bf16 products are exact in f32, so only summation order differs. Slots at
// or past n_slots[c] (when given) are empty: they read +inf and are neither
// staged nor multiplied.
//
// What bounds it: the bytes. At the 1M shape (1000 clusters of 1536 int8
// rows, d = 128, 112 slots, gs = 8) it reads 197 MB of rows and 29 MB of
// query slabs and writes 86 MB of minima: 0.093 ms at 3.35 TB/s, against
// 44 GFLOP of products, 0.044 ms at the bf16 tensor-core peak. A bf16 GEMM
// would also write the whole (qcap × cap) f32 product (688 MB); this kernel
// writes only the group minima. Streaming the rows alone runs near the
// bound; the int8 → bf16 conversion with xn, the products and the epilogue
// each cost about as much again when they run one after another, so the
// design runs them side by side, producers beside consumers:
//
// - One resident block per SM (16 warps) walks over items (cluster, chunk
//   of at most 128 slots), each over the whole bucket; the chunks of one
//   cluster are neighbours, so they read its rows from L2.
// - Eight producer warps (setmaxnreg 56) stream the rows: cp.async keeps a
//   ring of up to six raw 128-row tiles in flight; two threads a row then
//   convert a tile to bf16 (int8 through a byte permute and an add, exact,
//   not the quarter-rate I2F; bf16 copied), sum its xn with four partial
//   sums, and store it in one of two staged buffers. Named barriers (full /
//   empty) hand the buffers to the consumers, as in K1.
// - Eight consumer warps (setmaxnreg 200, two warpgroups) stage an item's
//   live slots once by cp.async (a chunk with none writes +inf and is
//   skipped by both sides) and sum qn from that copy. Products on the tensor
//   cores by wgmma: warpgroup g multiplies slots 64·g … 64·g + 63 (M) by the
//   tile's 128 rows (N) in 16-deep steps, both operands read from shared
//   memory by descriptor, K-major without swizzle (8-row × 16-byte core
//   matrices, which the producers' and the staging's 16-byte stores of
//   eight neighbouring rows fill without bank conflicts); a warpgroup with
//   no live slot skips them. mma.sync fed by ldmatrix took 0.11 ms for the
//   same products, and its fragments spent the shared-memory bandwidth.
// - The group minimum is taken in the epilogue, from the accumulators: the
//   min over the two rows a lane holds per n8 tile, a reduce-scatter over
//   the lane quad that leaves each lane four adjacent 8-row groups, then
//   + qn (rounding is monotone, so adding qn after the min rounds as adding
//   it to each). gs = 8 stores each lane's groups as one float4, whole
//   64-byte runs of a slot's row; longer groups meet in shared memory
//   (across tiles for gs > 128).
// - A depth whose tiles do not fit in shared memory (d = 960) goes in
//   slices, the slab's slice restaged by the consumers beside each.
//
// ptxas (sm_90a, the .log beside the built library): 128 registers at entry
// (512 threads), no spills; the consumers take 200 and the producers 56.
//
// The TPU kernel's VMEM slab budgets and static inner tiles have no
// counterpart here.

#include <algorithm>
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TR = 128;         // rows per tile (the wgmma N)
constexpr int MAX_CHUNK = 128;  // slots per item: two warpgroups of 64 (the wgmma M)
constexpr int CONSUMERS = 256;  // 2 warpgroups
constexpr int PRODUCERS = 256;  // 8 warps, two threads a row of the tile
constexpr int THREADS = CONSUMERS + PRODUCERS;
constexpr int CONSUMER_REGS = 200, PRODUCER_REGS = 56;  // setmaxnreg, 64K in all
constexpr int NB = 2;           // staged bf16 buffers
constexpr int MAX_RAW = 6;      // raw tiles in the ring
constexpr int M8_STRIDE = 20;   // floats per slot of the 8-row minima (16 + 4)
constexpr int SMEM_LIMIT = 232448;  // shared memory a block may opt into
// named barriers (0 is __syncthreads): a staged buffer is full / empty, the
// producers among themselves, the consumers among themselves
constexpr int BAR_FULL = 1, BAR_EMPTY = 3, BAR_PRODUCERS = 5, BAR_CONSUMERS = 6;

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Generic-proxy shared-memory stores before this are seen by later wgmma.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d_s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d_s),
               "l"(src), "r"(bytes));
}

// Wait until at most `pending` of this thread's cp.async groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    default: asm volatile("cp.async.wait_group 5;\n" ::); break;
  }
}

// Byte J of xu, an int8 with its sign bit flipped, as f32, exactly, without
// the quarter-rate I2F: the byte is the low mantissa byte of 2^23 + (x + 128),
// and subtracting 2^23 + 128 leaves x.
template <int J>
__device__ __forceinline__ float s8_to_f32(uint32_t xu) {
  return __uint_as_float(__byte_perm(xu, 0x4B000000u, 0x7540 | J)) - 8388736.f;
}

// Two f32 that hold integers of at most 8 significant bits as a bf16 pair
// (lo in the low half): their high halves, exactly.
__device__ __forceinline__ uint32_t pack_hi(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// Staged operands are K-major without swizzle: core matrices of 8 rows × 8
// bf16 (128 contiguous bytes, a row's 16 bytes after another's), the core
// matrices along the depth 128 bytes apart, those of the next 8 rows `kc`·16
// bytes on. Element (r, k) of such a buffer is at this byte offset; eight
// rows' 16-byte pieces at one depth are 128 contiguous bytes (no bank
// conflict).
__device__ __forceinline__ int core_off(int r, int k, int kc) {
  return (r >> 3) * kc * 16 + (k >> 3) * 128 + (r & 7) * 16 + (k & 7) * 2;
}

// The wgmma descriptor of such a buffer at `p`: start address, LBO = 128
// bytes (the next core matrix along the depth), SBO = kc·16 bytes (the next
// 8 rows), no swizzle.
__device__ __forceinline__ uint64_t core_desc(const void* p, int kc) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>((kc * 16) >> 4) << 32);
}

// d (64 f32 a thread) += A (64 slots × 16, descriptor da) · B (128 rows × 16,
// descriptor db)ᵀ, on the warpgroup's tensor cores; d is overwritten where
// accumulate is 0. Both operands K-major, bf16, f32 sums.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// INT8: the rows are int8, else bf16. The depth goes in slices of kc columns
// (kc == d unless the tiles would not fit in shared memory). `raw_n` raw
// tiles (2 … MAX_RAW) ring ahead of the staged buffers.
template <bool INT8>
__global__ void __launch_bounds__(THREADS, 1)
groupmin_kernel(const __nv_bfloat16* __restrict__ qsl, const void* __restrict__ rows_v,
                const float* __restrict__ w, const int32_t* __restrict__ n_slots,
                int ncl, int cap, int qcap, int d, int kc, int gs, int chunk,
                int chunks, int raw_n, bool aligned, float* __restrict__ out) {
  extern __shared__ __align__(1024) unsigned char smem[];
  // raw row stride, bytes: int8 rows padded by 16 where kc % 32 == 0, bf16
  // rows by 16, so that 8 rows' 16-byte pieces hit distinct banks
  const int rb = INT8 ? kc + (kc % 32 == 0 ? 16 : 0) : 2 * kc + 16;
  const int esz = INT8 ? 1 : 2;
  const int tile_bytes = TR * kc * 2;
  unsigned char* qs = smem;                          // [MAX_CHUNK][kc], core order
  unsigned char* xs = qs + MAX_CHUNK * kc * 2;       // [NB][TR][kc], core order
  float* m8 = reinterpret_cast<float*>(xs + NB * tile_bytes);  // [chunk][M8_STRIDE]
  float* xn_s = m8 + chunk * M8_STRIDE;  // [NB][TR]
  float* xn_acc = xn_s + NB * TR;        // [TR], the producers' sums over slices
  float* qn_s = xn_acc + TR;             // [chunk]
  float* run = qn_s + chunk;             // [chunk], a group longer than a tile
  float* w_s = run + chunk;              // [d]
  unsigned char* raw = reinterpret_cast<unsigned char*>(w_s + d);  // [raw_n][TR][rb]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int n_items = ncl * chunks;
  const int n_tiles = (cap + TR - 1) / TR;
  const int n_slices = (d + kc - 1) / kc;
  const int ng = cap / gs;
  // the live slots of item `it`'s chunk
  auto live_of = [&](int it) {
    const int c = it / chunks, q0 = (it % chunks) * chunk;
    const int live = n_slots != nullptr ? max(0, min(n_slots[c], qcap)) : qcap;
    return max(0, min(live - q0, min(chunk, qcap - q0)));
  };
  for (int i = tid; i < d; i += THREADS) w_s[i] = w[i];
  __syncthreads();

  if (tid >= CONSUMERS) {
    // ---- Producers (warpgroups 2 and 3): units (item, tile, depth slice)
    // in the consumers' order; a unit's raw rows are copied in raw_n − 1
    // units ahead, then converted by two threads a row into staged buffer
    // u % NB.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int pt = tid - CONSUMERS;
    const int pr = (pt >> 5) * 16 + (lane & 15), half = lane >> 4;  // row, half of its pieces
    const unsigned char* rows_b = static_cast<const unsigned char*>(rows_v);
    auto next_live = [&](int it) {  // the first item from `it` with live slots
      while (it < n_items && live_of(it) == 0) it += gridDim.x;
      return it;
    };
    int it_f = next_live(blockIdx.x), t_f = 0, sl_f = 0;  // the next unit to fetch
    int f = 0;                                            // units fetched
    auto fetch = [&]() {  // one unit's raw rows; commits one group, empty past the end
      if (it_f < n_items) {
        const int c = it_f / chunks, r0 = t_f * TR, k_lo = sl_f * kc;
        const int valid = min(TR, cap - r0);
        const int cpr = esz * min(kc, d - k_lo) / 16;  // 16-byte pieces a row
        unsigned char* dst0 = raw + (f % raw_n) * TR * rb;
        const unsigned char* src0 =
            rows_b + ((static_cast<int64_t>(c) * cap + r0) * d + k_lo) * esz;
        for (int i = pt; i < TR * cpr; i += PRODUCERS) {
          const int r = i / cpr, j = i % cpr;
          unsigned char* dst = dst0 + r * rb + 16 * j;
          const unsigned char* src = src0 + static_cast<int64_t>(r) * d * esz + 16 * j;
          if (aligned) {
            cp_async16(dst, r < valid ? src : rows_b, r < valid ? 16 : 0);
          } else {
            for (int e = 0; e < 16; ++e) dst[e] = r < valid ? src[e] : 0;
          }
        }
        if (++sl_f == n_slices) {
          sl_f = 0;
          if (++t_f == n_tiles) {
            t_f = 0;
            it_f = next_live(it_f + gridDim.x);
          }
        }
        ++f;
      }
      asm volatile("cp.async.commit_group;\n" ::);
    };
    for (int v = 0; v < raw_n - 1; ++v) fetch();
    cp_async_wait(raw_n - 2);  // this thread's part of unit 0 has landed
    int u = 0;  // units staged
    for (int it = next_live(blockIdx.x); it < n_items; it = next_live(it + gridDim.x)) {
      for (int t = 0; t < n_tiles; ++t) {
        for (int sl = 0; sl < n_slices; ++sl, ++u) {
          const int k_lo = sl * kc, kcur = min(kc, d - k_lo);
          const int b = u % NB;
          // unit u's raw rows have landed (each thread waited for its own
          // copies), and unit u − 1's are converted: its place takes the
          // unit raw_n − 1 ahead
          bar_sync(BAR_PRODUCERS, PRODUCERS);
          fetch();
          if (u >= NB) bar_sync(BAR_EMPTY + b, THREADS);
          // int8 → bf16 (exact) or a bf16 copy, and xn = Σ w·x² (x² is exact
          // in f32): two threads a row, every other 16-byte piece each
          const unsigned char* src = raw + ((u % raw_n) * TR + pr) * rb;
          unsigned char* dst = xs + b * tile_bytes;
          // four partial sums, one a 4-byte word, so the FMAs do not wait on
          // each other; pieces two at a time, so their loads overlap
          float p[4] = {0.f, 0.f, 0.f, 0.f};
          if (INT8) {
#pragma unroll 2
            for (int j = half; j < kcur / 16; j += 2) {
              const uint4 v = *reinterpret_cast<const uint4*>(src + 16 * j);
              const uint32_t words[4] = {v.x, v.y, v.z, v.w};
              uint32_t o[8];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const uint32_t xu = words[i] ^ 0x80808080u;
                const float f0 = s8_to_f32<0>(xu), f1 = s8_to_f32<1>(xu);
                const float f2 = s8_to_f32<2>(xu), f3 = s8_to_f32<3>(xu);
                const float4 wv =
                    *reinterpret_cast<const float4*>(w_s + k_lo + 16 * j + 4 * i);
                p[i] = __fmaf_rn(f3 * f3, wv.w, __fmaf_rn(f2 * f2, wv.z,
                       __fmaf_rn(f1 * f1, wv.y, __fmaf_rn(f0 * f0, wv.x, p[i]))));
                o[2 * i] = pack_hi(f0, f1);
                o[2 * i + 1] = pack_hi(f2, f3);
              }
              *reinterpret_cast<uint4*>(dst + core_off(pr, 16 * j, kc)) =
                  make_uint4(o[0], o[1], o[2], o[3]);
              *reinterpret_cast<uint4*>(dst + core_off(pr, 16 * j + 8, kc)) =
                  make_uint4(o[4], o[5], o[6], o[7]);
            }
          } else {
#pragma unroll 2
            for (int j = half; j < kcur / 8; j += 2) {
              const uint4 v = *reinterpret_cast<const uint4*>(src + 16 * j);
              *reinterpret_cast<uint4*>(dst + core_off(pr, 8 * j, kc)) = v;
              const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const float2 x = __bfloat1622float2(h[i]);
                const float2 wv = *reinterpret_cast<const float2*>(w_s + k_lo + 8 * j + 2 * i);
                p[i] = __fmaf_rn(x.y * x.y, wv.y, __fmaf_rn(x.x * x.x, wv.x, p[i]));
              }
            }
          }
          float part = (p[0] + p[1]) + (p[2] + p[3]);
          part += __shfl_xor_sync(0xffffffffu, part, 16);
          if (half == 0) {
            // xn over the slices so far; the last slice's buffer holds it
            const float sum = (sl == 0 ? 0.f : xn_acc[pr]) + part;
            xn_acc[pr] = sum;
            xn_s[b * TR + pr] = sum;
          }
          fence_async_smem();  // the staged tile is for wgmma
          bar_arrive(BAR_FULL + b, THREADS);
          cp_async_wait(raw_n - 2);  // this thread's part of unit u + 1 has landed
        }
      }
    }
    cp_async_wait(0);
    // take the consumers' last releases, so that no barrier is left open
    for (int v = max(u - NB, 0); v < u; ++v) bar_sync(BAR_EMPTY + v % NB, THREADS);
  } else {
    // ---- Consumers (warpgroups 0 and 1): per item, stage the live slots
    // and qn; per unit, warpgroup wg multiplies slots 64·wg … 64·wg + 63 by
    // the tile's 128 rows; per tile, the epilogue and the stores. A warp
    // holds 16 slots × 128 rows: slots 16·(warp % 4) + g and + 8, rows
    // 8·nt + 2·t4 + {0, 1} of n-tile nt, in d[4·nt + {0, 1}] and
    // d[4·nt + {2, 3}] (mma.sync's fragment, repeated over the 16 n-tiles).
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int g = lane >> 2, t4 = lane & 3;
    const int wg = warp >> 2;
    const int s_base = wg * 64 + (warp & 3) * 16;  // the warp's first slot
    const bool b1 = t4 & 2, b0 = t4 & 1;
    int u = 0;  // units consumed
    for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
      const int c = it / chunks, q0 = (it % chunks) * chunk;
      const int nq_chunk = min(chunk, qcap - q0);
      const int nl = live_of(it);
      float* out_c = out + static_cast<int64_t>(c) * qcap * ng;
      // the chunk's empty slots: +inf
      for (int i = tid; i < (nq_chunk - nl) * ng; i += CONSUMERS)
        out_c[static_cast<int64_t>(q0 + nl + i / ng) * ng + i % ng] = INFINITY;
      if (nl == 0) continue;  // the producers skip it too
      const bool wg_live = wg * 64 < nl, warp_live = s_base < nl;  // uniform per group / warp
      const __nv_bfloat16* qbase = qsl + (static_cast<int64_t>(c) * qcap + q0) * d;
      const int nl64 = (nl + 63) / 64 * 64;  // slots the warpgroups read
      // columns [k_lo, k_lo + kcur) of the slots into qs, zero past nl,
      // between two consumer barriers (the products before have read qs)
      auto stage_slab = [&](int k_lo, int kcur) {
        bar_sync(BAR_CONSUMERS, CONSUMERS);
        for (int i = tid; i < nl64 * (kcur / 8); i += CONSUMERS) {
          const int s = i / (kcur / 8), j = i % (kcur / 8);
          unsigned char* dst = qs + core_off(s, 8 * j, kc);
          const __nv_bfloat16* src = qbase + static_cast<int64_t>(s) * d + k_lo + 8 * j;
          if (aligned) {
            cp_async16(dst, s < nl ? src : qsl, s < nl ? 16 : 0);
          } else {
            uint4 v = make_uint4(0u, 0u, 0u, 0u);
            if (s < nl) {
              __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v);
              for (int q = 0; q < 8; ++q) e[q] = src[q];
            }
            *reinterpret_cast<uint4*>(dst) = v;
          }
        }
        asm volatile("cp.async.commit_group;\n" ::);
        cp_async_wait(0);
        fence_async_smem();
        bar_sync(BAR_CONSUMERS, CONSUMERS);
      };
      if (n_slices == 1) {
        stage_slab(0, d);
        // qn = 0.25·‖slot‖² from the staged slab, one thread a slot
        for (int s = tid; s < nl; s += CONSUMERS) {
          float sum = 0.f;
          for (int j = 0; j < d / 8; ++j) {
            const uint4 q = *reinterpret_cast<const uint4*>(qs + core_off(s, 8 * j, kc));
            const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float2 f2 = __bfloat1622float2(h[i]);
              sum = __fmaf_rn(f2.y, f2.y, __fmaf_rn(f2.x, f2.x, sum));
            }
          }
          qn_s[s] = 0.25f * sum;
        }
      } else {
        bar_sync(BAR_CONSUMERS, CONSUMERS);  // the item before is done with qn_s
        // qn from global memory, one thread a slot
        for (int s = tid; s < nl; s += CONSUMERS) {
          float sum = 0.f;
          for (int j = 0; j < d / 2; ++j) {
            const float2 f2 = __bfloat1622float2(__halves2bfloat162(
                qbase[static_cast<int64_t>(s) * d + 2 * j],
                qbase[static_cast<int64_t>(s) * d + 2 * j + 1]));
            sum = __fmaf_rn(f2.y, f2.y, __fmaf_rn(f2.x, f2.x, sum));
          }
          qn_s[s] = 0.25f * sum;
        }
      }
      bar_sync(BAR_CONSUMERS, CONSUMERS);  // qn_s is summed

      for (int t = 0; t < n_tiles; ++t) {
        const int r0 = t * TR;
        float acc[64];
        int b = 0;
        for (int sl = 0; sl < n_slices; ++sl, ++u) {
          const int k_lo = sl * kc, kcur = min(kc, d - k_lo);
          b = u % NB;
          if (n_slices > 1) stage_slab(k_lo, kcur);
          bar_sync(BAR_FULL + b, THREADS);
          if (wg_live) {
            const uint64_t da = core_desc(qs + wg * 8 * kc * 16, kc);
            const uint64_t db = core_desc(xs + b * tile_bytes, kc);
            asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
            // each 16-deep step: the next two core matrices along the depth
            // (256 bytes, 16 in the descriptor's units)
            for (int k = 0; k < kcur / 16; ++k)
              wgmma_m64n128k16(acc, da + 16 * k, db + 16 * k, sl > 0 || k > 0);
            asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
            asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
          }
          if (sl + 1 < n_slices) bar_arrive(BAR_EMPTY + b, THREADS);  // the unit is read
        }

        // Epilogue: (acc + xn) for the (slot, row) pairs held, the min over
        // each 8-row group, a reduce-scatter over the quad that leaves each
        // lane four adjacent groups (n-tiles 4·t4 … 4·t4 + 3), then + qn
        // (rounding is monotone, so adding qn after the min rounds as adding
        // it to each). gs = 8: each lane stores its four groups as one
        // float4, so a warp writes 64 contiguous bytes a slot; longer groups
        // meet in m8.
        const int valid = min(TR, cap - r0);
        if (warp_live) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int s = s_base + h * 8 + g;
            float v[16];
#pragma unroll
            for (int nt = 0; nt < 16; ++nt) {
              const float2 xn = *reinterpret_cast<const float2*>(xn_s + b * TR + nt * 8 + 2 * t4);
              v[nt] = fminf(__fadd_rn(acc[4 * nt + 2 * h], xn.x),
                            __fadd_rn(acc[4 * nt + 2 * h + 1], xn.y));
            }
            // with lane t4 ^ 2: keep n-tiles 8·(t4 / 2) + {0 … 7}
            float k8[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
              k8[i] = fminf(b1 ? v[8 + i] : v[i],
                            __shfl_xor_sync(0xffffffffu, b1 ? v[i] : v[8 + i], 2));
            // with lane t4 ^ 1: keep n-tiles 4·t4 + {0 … 3}
            float m[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              m[i] = fminf(b0 ? k8[4 + i] : k8[i],
                           __shfl_xor_sync(0xffffffffu, b0 ? k8[i] : k8[4 + i], 1));
            if (s < nl) {
              const float qv = qn_s[s];
              const float4 r = make_float4(__fadd_rn(m[0], qv), __fadd_rn(m[1], qv),
                                           __fadd_rn(m[2], qv), __fadd_rn(m[3], qv));
              const int grp = 4 * t4;  // the lane's first 8-row group in the tile
              if (gs == 8) {
                if (8 * grp < valid)
                  *reinterpret_cast<float4*>(out_c + static_cast<int64_t>(q0 + s) * ng +
                                             r0 / 8 + grp) = r;
              } else {
                *reinterpret_cast<float4*>(m8 + s * M8_STRIDE + grp) = r;
              }
            }
          }
        }
        bar_arrive(BAR_EMPTY + b, THREADS);  // the tile's (last) buffer is read
        if (gs > 8) {
          bar_sync(BAR_CONSUMERS, CONSUMERS);  // the tile's 8-row minima are in m8
          // the tile's groups (or, for gs > TR, the running min of one
          // group), each slot's groups one contiguous run
          if (gs <= TR) {
            const int per = gs / 8, groups = valid / gs, g0 = r0 / gs;
            for (int i = tid; i < nl * groups; i += CONSUMERS) {
              const int s = i / groups, gi = i % groups;
              const float* m = m8 + s * M8_STRIDE + gi * per;
              float v = m[0];
              for (int j = 1; j < per; ++j) v = fminf(v, m[j]);
              out_c[static_cast<int64_t>(q0 + s) * ng + g0 + gi] = v;
            }
          } else {
            const bool first = r0 % gs == 0, last = (r0 + TR) % gs == 0;
            for (int s = tid; s < nl; s += CONSUMERS) {
              const float* m = m8 + s * M8_STRIDE;
              float v = m[0];
              for (int j = 1; j < TR / 8; ++j) v = fminf(v, m[j]);
              if (!first) v = fminf(v, run[s]);
              if (last) out_c[static_cast<int64_t>(q0 + s) * ng + r0 / gs] = v;
              else run[s] = v;
            }
          }
          bar_sync(BAR_CONSUMERS, CONSUMERS);  // m8 is read
        }
      }
    }
  }
}

int smem_bytes(bool int8, int chunk, int d, int kc, int raw_n) {
  const int rb = int8 ? kc + (kc % 32 == 0 ? 16 : 0) : 2 * kc + 16;
  return MAX_CHUNK * kc * 2 + NB * TR * kc * 2 + chunk * M8_STRIDE * 4 + (NB + 1) * TR * 4 +
         2 * chunk * 4 + d * 4 + raw_n * TR * rb;
}

}  // namespace

extern "C" {

// qsl (ncl, qcap, d) bf16; rows (ncl·cap, d) int8 (rows_int8 != 0) or bf16;
// w (d,) f32; n_slots (ncl,) int32 or null; out (ncl, qcap, cap/gs) f32.
// Needs d % 16 == 0, gs a power of two ≥ 8, cap % max(gs, 64) == 0 (the
// wrapper checks). Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError().
int vaq_groupmin_window_scan(const void* qsl, const void* rows, int rows_int8,
                             const void* w, const void* n_slots, int ncl, int cap,
                             int qcap, int d, int gs, void* out, void* stream) {
  if (ncl <= 0 || cap <= 0 || qcap <= 0) return static_cast<int>(cudaGetLastError());
  const int chunk = qcap < MAX_CHUNK ? (qcap + 15) / 16 * 16 : MAX_CHUNK;
  const int chunks = (qcap + chunk - 1) / chunk;
  const bool int8 = rows_int8 != 0;
  // the whole depth at once where two raw tiles fit, else slices of a
  // multiple of 32; then as many raw tiles as fit, up to MAX_RAW
  int kc = d;
  while (kc > 32 && smem_bytes(int8, chunk, d, kc, 2) > SMEM_LIMIT) kc = (kc - 1) / 32 * 32;
  int raw_n = 2;
  while (raw_n < MAX_RAW && smem_bytes(int8, chunk, d, kc, raw_n + 1) <= SMEM_LIMIT) ++raw_n;
  const int smem = smem_bytes(int8, chunk, d, kc, raw_n);
  const bool aligned = (reinterpret_cast<uintptr_t>(qsl) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(rows) & 15) == 0;
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  const int64_t n_items = static_cast<int64_t>(ncl) * chunks;
  const auto grid = static_cast<unsigned>(std::min<int64_t>(n_items, std::max(n_sm, 1)));
  auto kernel = int8 ? groupmin_kernel<true> : groupmin_kernel<false>;
  // Above 48 KB a launch is refused unless the kernel opted in; the caller
  // checks the returned error, so a refusal is never silent.
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(qsl), rows, static_cast<const float*>(w),
      static_cast<const int32_t*>(n_slots), ncl, cap, qcap, d, kc, gs, chunk, chunks, raw_n,
      aligned, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
