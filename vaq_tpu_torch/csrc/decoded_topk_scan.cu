// D1 — the decoded tier's fused score product and top-kk selection.
//
// It replaces no Pallas kernel: the JAX package leaves this tier to XLA, a
// GEMM of the bf16 query against the resident bf16 rows and approx_max_k
// over the (nq, n) scores (vaq_tpu/ops/scan_decoded.py:48-76, 213-293). The
// port first ran it as plain PyTorch, which upcast each 65,536-row block to
// f32, wrote its (nq, 65,536) f32 scores, rewrote them twice and radix-
// selected from them: at 1024 queries × 1M rows about 4 GB of scores a
// batch, 27.6 ms on an H100 against a bound of 0.27 ms. Here the scores
// never leave the chip.
//
// For every query q (bf16, the bf16-rounded projected query) and live row x
// (bf16) it scores
//     score = ‖x‖² − 2·(q·x),
// the product on the tensor cores (bf16 × bf16, exact in f32, summed in
// f32), ‖x‖² the tier's f32 norm (+inf for a tombstoned row), one rounding
// (an fma of the exact 2·dot), as the plain version's ``norms − 2·(q @ xᵀ)``
// rounds. It keeps, for each query and each of the grid's row splits, the
// kk lowest keys
//     key = (score as int32 in IEEE total order) << 32 | row,
// so ties go to the lower row and −0 sorts below +0, as jax.lax.top_k's
// order and ``distances.lowest_over_blocks`` keep them. A row whose score
// is NaN is never kept. The wrapper (ops/scan_decoded.py) sorts the splits'
// keys of each query and takes the kk lowest: the kk lowest of the whole,
// since every one of them is among the kk lowest of its own split.
//
// What bounds it: 2·nq·n·d operations, 2·1024·1M·128 ≈ 268 GFLOP a batch,
// 0.27 ms at the H100 SXM's 989 TFLOP/s bf16, against 256 MB of rows read
// once (0.08 ms at 3.35 TB/s). The selection must cost a compare a score,
// not a pass over memory. The design:
//
// - The grid is (row splits, query groups), one block an SM. Split s takes
//   the 64-row tiles s, s + S, s + 2S, …; the blocks of the query groups
//   walk the same tiles at the same time, so the rows come from HBM about
//   once and from L2 for the other groups.
// - A block is up to 8 warps. Each owns 16·MT queries (MT = 2 at the main
//   shapes: 32), staged once in shared memory, and multiplies them against
//   every tile with mma.sync.m16n8k16, the queries as A and the rows as B,
//   so each query's scores of a tile sit in one quad of lanes. Tiles arrive
//   in a ring of shared-memory stages (the depth zero-padded to a multiple
//   of 16, plus 8 bf16 so that each ldmatrix phase touches all 32 banks):
//   the warps take turns to copy a tile two stages ahead by 16-byte
//   cp.async, each lane arriving on the stage's mbarrier once its copies
//   land; a stage is refilled once every warp has released it. No warp is
//   kept for loading: with 8 warps a block the compiler may give each thread 255
//   registers (9 would cap it at 168 and put the accumulators in local
//   memory). Rows that are not whole 16-byte pieces are copied by plain
//   loads.
// - The epilogue: score = fma(−2, acc, norm); the least of each query's 16
//   scores a lane holds is tested against the query's bound, held in
//   registers: branch-free, a compare a score. A tile none of whose scores
//   pass costs one vote of the warp.
// - A passing score is staged as its key in its query's slots in shared
//   memory (16 a query). Lane i owns query i's max-heap of kk keys in shared
//   memory and inserts the staged keys in a drain: every 4 tiles, at the
//   split's last tile, or at once when a query's slots fill. Ties are broken
//   by the row, so the heap holds exactly the kk lowest keys of its split
//   that lie below the bound.
// - The bound is the lowest of three, each a key no smaller than the kk-th
//   lowest of the whole, so that no key at or above one can be among the kk
//   lowest unless it is that bound's own key, which its split keeps: the
//   heap's kk-th key once full; the lowest kk-th key any split of the query
//   published (an atomicMin in global memory, read once a tile through L2);
//   and, where there are at least kk splits, the kk-th smallest of the
//   lowest keys of the first kk + 7 splits (one a split, read at tiles 1,
//   2, 4, … 32 and every 256th, each owner its own), below which lie at
//   least kk distinct keys. At the benchmark's shape
//   (1024 queries, 4 groups × 33 splits, kk = 26) about 2.2M keys are
//   inserted a batch and D1 takes 1.43 ms on an H100 SXM; with the plain
//   scan's kk-th key given as the bound from the start, 26,624 keys and
//   1.12 ms.
// - Each warp writes its queries' heaps (kk keys, INT64_MAX where the split
//   kept fewer) and adds its inserts to the block's counter.
//
// Where kk or the depth is large, the host picks fewer warps, 16-query
// warps or fewer stages so that queries, heaps, slots and stages fit in the
// 227 KB a block may have (ops/scan_decoded.py, _d1_geometry): up to kk =
// 512 at depth 960. The wrapper takes it for kk ≤ 512 and depths ≤ 960,
// the plain blocked path above them: a rule on shapes alone.
//
// No two warps write one heap, and no block waits on another: a block only
// reads the bounds other blocks have published so far.

#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TR = 64;            // rows a tile: 8 n-tiles of 8
constexpr int PAD = 8;            // bf16 after each staged row
constexpr int MAX_WARPS = 8;      // warps a block (two an SM sub-partition: 255 registers)
constexpr int SLOTS = 16;         // keys a query stages between drains
constexpr int DRAIN_EARLY = 4;    // tiles between drains in a split's first 64, unless the slots fill
constexpr int DRAIN_LATE = 32;    // and after them, when few keys pass
constexpr int HEAD = 128;         // bytes before the ring: the stages' two mbarriers each
constexpr int MAX_STAGES = HEAD / 16;
constexpr long long EMPTY_KEY = LLONG_MAX;
constexpr unsigned FULL = 0xffffffffu;

// A block's dynamic shared memory, in byte offsets: the mbarriers (HEAD),
// the ring of `stages` 64-row tiles and the warps' queries (rows of sx
// bf16), each query's max-heap of kk keys, its SLOTS staged keys and their
// count. The kernel carves its buffer by these offsets and the launch
// refuses a smaller buffer, so the layout is written here alone.
struct Layout {
  size_t xs, qs, heaps, slots, counts, bytes;
  __host__ __device__ Layout(int stages, int warps, int qw, int sx, int kk)
      : xs(HEAD),
        qs(xs + static_cast<size_t>(stages) * TR * sx * 2),
        heaps(qs + static_cast<size_t>(warps) * qw * sx * 2),
        slots(heaps + static_cast<size_t>(warps) * qw * kk * 8),
        counts(slots + static_cast<size_t>(warps) * qw * SLOTS * 8),
        bytes(counts + static_cast<size_t>(warps) * qw * 4) {}
};

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// Arrives on `bar` once every cp.async this thread issued before has landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 16-deep step's operands of a warp: MT query tiles of 16 (A)
// and 8 row tiles of 8 (B, two per ldmatrix).
template <int MT>
struct Frags {
  uint32_t a[MT][4], b[4][4];
};

template <int MT>
__device__ __forceinline__ void load_frags(Frags<MT>& f, const __nv_bfloat16* pa,
                                           const __nv_bfloat16* pb, int sx, int k0) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(f.a[mt], pa + mt * 16 * sx + k0);
#pragma unroll
  for (int j = 0; j < 4; ++j) ldmatrix_x4(f.b[j], pb + j * 16 * sx + k0);
}

template <int MT>
__device__ __forceinline__ void mma_frags(float (&acc)[MT][8][4], const Frags<MT>& f) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
      mma_bf16(acc[mt][nt], f.a[mt], f.b[nt >> 1][(nt & 1) * 2], f.b[nt >> 1][(nt & 1) * 2 + 1]);
}

// acc = the warp's 16·MT queries × 64 rows over dpad (a multiple of 16) of
// depth, the next step's fragments loaded before this step's products.
// STEPS > 0: dpad = 16·STEPS, fully unrolled (depths 128 and 96).
template <int MT, int STEPS>
__device__ __forceinline__ void mma_depth(float (&acc)[MT][8][4], const __nv_bfloat16* pa,
                                          const __nv_bfloat16* pb, int sx, int dpad) {
  Frags<MT> f[2];
  load_frags(f[0], pa, pb, sx, 0);
  if constexpr (STEPS > 0) {
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
      if (k + 1 < STEPS) load_frags(f[(k + 1) & 1], pa, pb, sx, 16 * (k + 1));
      mma_frags(acc, f[k & 1]);
    }
  } else {
    for (int k0 = 0; k0 < dpad; k0 += 32) {
      const bool two = k0 + 16 < dpad;
      if (two) load_frags(f[1], pa, pb, sx, k0 + 16);
      mma_frags(acc, f[0]);
      if (two) {
        if (k0 + 32 < dpad) load_frags(f[0], pa, pb, sx, k0 + 32);
        mma_frags(acc, f[1]);
      }
    }
  }
}

// acc = the warp's 16·MT queries × 64 rows over 16·STEPS of depth, the
// queries' fragments held in registers for the whole kernel (aq, loaded
// once), the rows' next step loaded before this step's products.
template <int MT, int STEPS>
__device__ __forceinline__ void mma_rows(float (&acc)[MT][8][4],
                                         const uint32_t (&aq)[MT][STEPS][4],
                                         const __nv_bfloat16* pb, int sx) {
  uint32_t b[2][4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) ldmatrix_x4(b[0][j], pb + j * 16 * sx);
#pragma unroll
  for (int k = 0; k < STEPS; ++k) {
    if (k + 1 < STEPS)
#pragma unroll
      for (int j = 0; j < 4; ++j) ldmatrix_x4(b[(k + 1) & 1][j], pb + j * 16 * sx + 16 * (k + 1));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        mma_bf16(acc[mt][nt], aq[mt][k], b[k & 1][nt >> 1][(nt & 1) * 2],
                 b[k & 1][nt >> 1][(nt & 1) * 2 + 1]);
  }
}

// The kk-th smallest of the first p = min(n, kk + TOP − 1) of the n keys at
// `at` (kk ≤ n), read through L2: the (p − kk + 1)-th largest, kept among
// the TOP largest in registers as the keys stream by.
constexpr int TOP = 8;
__device__ __forceinline__ long long kth_smallest(const long long* at, int n, int kk) {
  const int p = min(n, kk + TOP - 1);
  long long t[TOP];  // the largest so far, descending
#pragma unroll
  for (int i = 0; i < TOP; ++i) t[i] = LLONG_MIN;
#pragma unroll 8
  for (int k = 0; k < p; ++k) {
    const long long x = __ldcg(at + k);
#pragma unroll
    for (int i = TOP - 1; i > 0; --i) t[i] = max(t[i], min(t[i - 1], x));
    t[0] = max(t[0], x);
  }
  long long kth = t[0];
#pragma unroll
  for (int i = 1; i < TOP; ++i)
    if (i == p - kk) kth = t[i];
  return kth;
}

// f32 bits as an int32 whose order is IEEE total order (−0 below +0); the
// map is its own inverse.
__device__ __forceinline__ int32_t ordered(int32_t bits) {
  return bits ^ ((bits >> 31) & 0x7fffffff);
}

__device__ __forceinline__ long long make_key(float score, int64_t row) {
  const uint32_t hi = static_cast<uint32_t>(ordered(__float_as_int(score)));
  return static_cast<long long>((static_cast<unsigned long long>(hi) << 32) |
                                static_cast<uint32_t>(row));
}

__device__ __forceinline__ float key_score(long long key) {
  return __int_as_float(ordered(static_cast<int32_t>(key >> 32)));
}

// Insert `key` into the max-heap h[0 .. cnt) (entry i at h[i·stride]) of at
// most kk keys; returns whether it went in.
__device__ __forceinline__ bool heap_insert(long long* h, int stride, int kk, int& cnt,
                                            long long key) {
  if (cnt < kk) {
    int i = cnt++;
    while (i > 0) {
      const int p = (i - 1) >> 1;
      const long long hp = h[p * stride];
      if (hp >= key) break;
      h[i * stride] = hp;
      i = p;
    }
    h[i * stride] = key;
    return true;
  }
  if (key >= h[0]) return false;
  int i = 0;
  for (;;) {
    int c = 2 * i + 1;
    if (c >= kk) break;
    long long hc = h[c * stride];
    if (c + 1 < kk) {
      const long long h2 = h[(c + 1) * stride];
      if (h2 > hc) {
        hc = h2;
        ++c;
      }
    }
    if (hc <= key) break;
    h[i * stride] = hc;
    i = c;
  }
  h[i * stride] = key;
  return true;
}

template <int MT, int STEPS>
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
decoded_topk_scan_kernel(const __nv_bfloat16* __restrict__ rows, int64_t n, int d, int dpad,
                         const float* __restrict__ norms, const __nv_bfloat16* __restrict__ q,
                         int nq, int kk, int warps, int stages, int vec,
                         long long* __restrict__ cand, long long* __restrict__ bound,
                         long long* __restrict__ mins, unsigned long long* __restrict__ kept) {
  constexpr int QW = 16 * MT;  // queries a warp
  extern __shared__ __align__(128) unsigned char smem[];
  const int sx = dpad + PAD;
  const Layout lay(stages, warps, QW, sx, kk);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + stages;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem + lay.xs);  // [stages][TR][sx]
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem + lay.qs);  // [warps·QW][sx]
  long long* heaps = reinterpret_cast<long long*>(smem + lay.heaps);    // [warps][kk][QW]
  long long* slots = reinterpret_cast<long long*>(smem + lay.slots);    // [warps][QW][SLOTS]
  int* counts = reinterpret_cast<int*>(smem + lay.counts);              // [warps][QW]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qb = warps * QW;
  const int q0 = blockIdx.y * qb;
  const int nqb = min(qb, nq - q0);
  const int64_t n_tiles = (n + TR - 1) / TR;
  const int split = blockIdx.x, n_splits = gridDim.x;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // The depth padding of every stage and of the queries holds zeros (shared
  // memory never written may hold NaN bits, and NaN × 0 is NaN); queries
  // past nq are zero.
  if (dpad > d)
    for (int i = tid; i < stages * TR * (dpad - d); i += blockDim.x) {
      const int r = i / (dpad - d), c = d + i % (dpad - d);
      xs[static_cast<size_t>(r) * sx + c] = __float2bfloat16_rn(0.f);
    }
  for (int i = tid; i < qb; i += blockDim.x) counts[i] = 0;
  for (int i = tid; i < qb * dpad; i += blockDim.x) {
    const int qq = i / dpad, c = i % dpad;
    qs[static_cast<size_t>(qq) * sx + c] =
        (qq < nqb && c < d) ? q[static_cast<int64_t>(q0 + qq) * d + c] : __float2bfloat16_rn(0.f);
  }
  __syncthreads();

  // Warp j mod warps copies tile j into the ring: 16-byte cp.async pieces,
  // then each lane arrives on the stage's barrier once its copies have
  // landed; or plain loads where a row is not whole 16-byte pieces. Tile j
  // goes into stage j mod stages `ahead` tiles before it is needed, once
  // every warp has released that stage's previous tile, `lag` tiles back.
  const int lag = stages >= 4 ? 2 : 1, ahead = stages - lag;
  const int64_t my_tiles = split < n_tiles ? (n_tiles - 1 - split) / n_splits + 1 : 0;
  const int chunks = d / 8;  // 16-byte pieces a row
  // this lane's pieces: lane, lane + 32, … of the tile, walked as (row,
  // piece) without a division a piece
  const int r_first = vec ? lane / chunks : 0, c_first = vec ? lane % chunks : 0;
  const int r_step = vec ? 32 / chunks : 0, c_step = vec ? 32 % chunks : 0;
  auto fetch = [&](int64_t jt) {
    const int st = static_cast<int>(jt % stages);
    const int64_t u = jt / stages;
    if (u > 0) mbar_wait(&empty[st], static_cast<uint32_t>((u - 1) & 1));
    const int64_t r0 = (split + jt * n_splits) * TR;
    const int valid = static_cast<int>(min(static_cast<int64_t>(TR), n - r0));
    __nv_bfloat16* xb = xs + static_cast<size_t>(st) * TR * sx;
    const __nv_bfloat16* src = rows + r0 * d;
    if (vec) {
      for (int r = r_first, c = c_first; r < valid;) {
        cp_async16(xb + r * sx + c * 8, src + r * d + c * 8);
        r += r_step;
        c += c_step;
        if (c >= chunks) {
          c -= chunks;
          ++r;
        }
      }
      cp_async_arrive(&full[st]);
    } else {
      for (int i = lane; i < valid * d; i += 32) {
        const int r = i / d, c = i % d;
        xb[static_cast<size_t>(r) * sx + c] = src[static_cast<int64_t>(r) * d + c];
      }
      mbar_arrive(&full[st]);
    }
  };
  for (int64_t jt = warp; jt < min(static_cast<int64_t>(ahead), my_tiles); jt += warps) fetch(jt);

  const int g = lane >> 2, tq = lane & 3;
  long long* heap = heaps + static_cast<size_t>(warp) * kk * QW + lane;  // entry i at [i·QW]
  long long* slot = slots + static_cast<size_t>(warp) * QW * SLOTS + lane * SLOTS;
  int* staged = counts + warp * QW;
  // ldmatrix addresses: A queries (lane % 16), column half (lane / 16); B
  // rows (lane % 8) + 8·(lane / 16), column half ((lane / 8) % 2)
  const __nv_bfloat16* pa = qs + static_cast<size_t>(warp * QW + (lane & 15)) * sx + (lane >> 4) * 8;
  const int pb_off = ((lane & 7) + (lane >> 4) * 8) * sx + ((lane >> 3) & 1) * 8;
  // at depths 128 and 96 the queries' fragments stay in registers
  uint32_t aq[MT][STEPS > 0 ? STEPS : 1][4];
  if constexpr (STEPS > 0) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int k = 0; k < STEPS; ++k) ldmatrix_x4(aq[mt][k], pa + mt * 16 * sx + 16 * k);
  }

  // Lane i < QW owns query qi's heap. Its bound is the lowest of: its
  // heap's kk-th key once full; the lowest kk-th key any split published
  // (`bound`); and, where there are at least kk splits, the kk-th smallest
  // of the splits' lowest keys (`mins`, one a split), at or below which lie
  // kk distinct keys, one a split. No key at or above a bound can be among
  // the kk lowest of the whole unless it is that bound's own key, which its
  // split keeps.
  const int qi = q0 + warp * QW + lane;
  const bool owner = lane < QW && qi < nq;
  long long* shared_bound = owner ? bound + qi : nullptr;
  long long* my_min = owner && mins ? mins + static_cast<int64_t>(qi) * n_splits : nullptr;
  long long own = EMPTY_KEY, published = EMPTY_KEY, global = EMPTY_KEY;
  long long lowest = EMPTY_KEY, published_low = EMPTY_KEY;
  int cnt = 0;                 // the owner's heap size
  unsigned long long ins = 0;  // keys the owner inserted
  float tf[MT][2];             // the bound's score of query mt·16 + h·8 + g
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) tf[mt][0] = tf[mt][1] = __int_as_float(0x7f800000);

  const bool any_query = q0 + warp * QW < nq;
  int j = 0, since = 0;
  for (int64_t t = split; t < n_tiles; t += n_splits, ++j) {
    if (j + ahead < my_tiles && (j + ahead) % warps == warp) fetch(j + ahead);
    const int s = j % stages, u = j / stages;
    const int64_t r0 = t * TR;
    // the other splits' bound, read through L2 while this tile multiplies
    const long long seen = owner ? __ldcg(shared_bound) : EMPTY_KEY;
    // this thread's rows: nt·8 + 2·tq + e; NaN past n, so they never pass
    float nrm[8][2];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int64_t row = r0 + nt * 8 + 2 * tq + e;
        nrm[nt][e] = row < n ? __ldg(norms + row) : __int_as_float(0x7fffffff);
      }
    float acc[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
    mbar_wait(&full[s], u & 1);
    const __nv_bfloat16* pb = xs + static_cast<size_t>(s) * TR * sx + pb_off;
    if (any_query) {
      if constexpr (STEPS > 0) mma_rows<MT, STEPS>(acc, aq, pb, sx);
      else mma_depth<MT, 0>(acc, pa, pb, sx, dpad);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the stage is read
    if (!any_query) continue;

    if (seen < global) global = seen;
    const float mine = key_score(min(own, global));  // NaN (none) or the bound
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        tf[mt][h] = fminf(tf[mt][h], __shfl_sync(FULL, mine, mt * 16 + h * 8 + g));

    // Epilogue: the scores, and the least of each query's 16 a lane holds
    // against its bound: a compare a score, branch-free.
    float low[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) low[mt][0] = low[mt][1] = __int_as_float(0x7fffffff);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // 2·dot is exact, so the fma rounds as norm − 2·dot does
          acc[mt][nt][i] = __fmaf_rn(-2.f, acc[mt][nt][i], nrm[nt][i & 1]);
          low[mt][i >> 1] = fminf(low[mt][i >> 1], acc[mt][nt][i]);
        }
    unsigned groups = 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (low[mt][h] <= tf[mt][h]) groups |= 1u << (mt * 2 + h);
    // The scores that pass, as bits (mt·8 + nt)·4 + i of a mask, go to
    // their query's slots one at a time (a select picks the score); where a
    // query's slots are full, the warp drains and the bits that still pass
    // go on. Drains also come every DRAIN_EARLY tiles (DRAIN_LATE after the
    // split's first 64) and at its last tile, where keys are staged. One loop and one drain, so that the
    // code a rare pass runs stays small.
    unsigned long long pass = 0;
    if (__any_sync(FULL, groups != 0) && groups) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (acc[mt][nt][i] <= tf[mt][i >> 1]) pass |= 1ull << ((mt * 8 + nt) * 4 + i);
    }
    const bool flush = ++since >= (j < 64 ? DRAIN_EARLY : DRAIN_LATE) || t + n_splits >= n_tiles;
    for (;;) {
      for (unsigned long long left = pass; left; left &= left - 1) {
        const int b = __ffsll(static_cast<long long>(left)) - 1;
        float sc = acc[0][0][0];
#pragma unroll
        for (int x = 1; x < 32 * MT; ++x)
          if (b == x) sc = acc[x >> 5][(x >> 2) & 7][x & 3];
        const int mt = b >> 5, h = (b >> 1) & 1;
        const float lim = mt ? (h ? tf[MT - 1][1] : tf[MT - 1][0]) : (h ? tf[0][1] : tf[0][0]);
        const unsigned long long bit = 1ull << b;
        if (!(sc <= lim)) {
          pass &= ~bit;
          continue;
        }
        const int ql = mt * 16 + h * 8 + g;
        const int at = atomicAdd(staged + ql, 1);
        if (at < SLOTS) {
          slots[(static_cast<size_t>(warp) * QW + ql) * SLOTS + at] =
              make_key(sc, r0 + ((b >> 2) & 7) * 8 + 2 * tq + (b & 1));
          pass &= ~bit;
        }
      }
      if (!__any_sync(FULL, pass != 0) &&
          !(flush && __any_sync(FULL, lane < QW && staged[lane] > 0)))
        break;
      // A drain: lane i < QW inserts the keys staged for its query (those
      // below the shared bound) into its heap and publishes its heap's kk-th
      // key and its split's lowest key; then every lane takes the new bounds
      // of its queries.
      __syncwarp();
      if (lane < QW) {
        const int m = min(staged[lane], SLOTS);
        for (int r = 0; r < m; ++r) {
          const long long key = slot[r];
          if (key < global && heap_insert(heap, QW, kk, cnt, key)) {
            ++ins;
            lowest = min(lowest, key);
          }
        }
        staged[lane] = 0;
        if (cnt == kk) own = heap[0];
        if (owner && own < published) {
          atomicMin(shared_bound, own);
          published = own;
        }
        if (my_min && lowest < published_low) {
          my_min[split] = lowest;
          published_low = lowest;
        }
      }
      __syncwarp();
      const float now = key_score(min(own, global));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          tf[mt][h] = fminf(tf[mt][h], __shfl_sync(FULL, now, mt * 16 + h * 8 + g));
      since = 0;  // a flushing tile ends with nothing staged
    }
    // The splits' lowest keys, read again at tiles 0, 1, 2, 4, … 32 and
    // every 256th: the kk-th smallest of the first kk + 7 (kk distinct keys
    // lie at or below it).
    if (my_min && (((j & (j - 1)) == 0 && j <= 32) || (j & 255) == 0)) {
      const long long kth = kth_smallest(my_min, n_splits, kk);
      if (kth < global) global = kth;
    }
  }

  // The warp's lists: query ql's kk keys at cand[(q·S + split)·kk …].
  for (int ql = 0; ql < QW; ++ql) {
    const int have = __shfl_sync(FULL, cnt, ql);
    const int qi = q0 + warp * QW + ql;
    if (qi >= nq) break;
    long long* out = cand + (static_cast<int64_t>(qi) * n_splits + split) * kk;
    const long long* h = heaps + static_cast<size_t>(warp) * kk * QW + ql;
    for (int i = lane; i < kk; i += 32) out[i] = i < have ? h[i * QW] : EMPTY_KEY;
  }
  unsigned long long total = ins;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) total += __shfl_xor_sync(FULL, total, o);
  if (kept && lane == 0 && total) atomicAdd(kept + blockIdx.y * n_splits + split, total);
}

template <int MT, int STEPS>
int launch(const void* rows, int64_t n, int d, int dpad, const void* norms, const void* q,
           int nq, int kk, int warps, int stages, int splits, int smem, int vec, void* cand,
           void* bound, void* mins, void* kept, cudaStream_t stream) {
  auto kernel = decoded_topk_scan_kernel<MT, STEPS>;
  // Above 48 KB a launch is refused unless the kernel opted in; the caller
  // checks the returned error, so a refusal is never silent.
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int qb = warps * 16 * MT;
  const dim3 grid(static_cast<unsigned>(splits), static_cast<unsigned>((nq + qb - 1) / qb));
  kernel<<<grid, 32 * warps, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(rows), n, d, dpad, static_cast<const float*>(norms),
      static_cast<const __nv_bfloat16*>(q), nq, kk, warps, stages, vec,
      static_cast<long long*>(cand), static_cast<long long*>(bound),
      static_cast<long long*>(mins), static_cast<unsigned long long*>(kept));
  return static_cast<int>(cudaGetLastError());
}

template <int MT>
int launch_depth(int dpad, const void* rows, int64_t n, int d, const void* norms, const void* q,
                 int nq, int kk, int warps, int stages, int splits, int smem, int vec,
                 void* cand, void* bound, void* mins, void* kept, cudaStream_t stream) {
  if (dpad == 128)
    return launch<MT, 8>(rows, n, d, dpad, norms, q, nq, kk, warps, stages, splits, smem, vec,
                         cand, bound, mins, kept, stream);
  if (dpad == 96)
    return launch<MT, 6>(rows, n, d, dpad, norms, q, nq, kk, warps, stages, splits, smem, vec,
                         cand, bound, mins, kept, stream);
  return launch<MT, 0>(rows, n, d, dpad, norms, q, nq, kk, warps, stages, splits, smem, vec,
                       cand, bound, mins, kept, stream);
}

}  // namespace

extern "C" {

// rows (n, d) bf16 row-major; norms (n,) f32; q (nq, d) bf16; cand (nq,
// splits, kk) int64, written whole; bound (nq·(1 + splits),) int64 must
// hold INT64_MAX on entry, and kept (query groups · splits) u64 0 unless
// null (then the inserts are not counted): bound[q] is the lowest kk-th key
// a split of query q published, bound[nq + q·splits + s] split s's lowest
// key (used where splits ≥ kk). mt (1 or 2: 16·mt queries a warp), warps
// (1-8 warps), stages (1-8 ring stages) and smem (the block's dynamic
// shared memory) come from the wrapper (ops/scan_decoded.py, _d1_geometry);
// smem must hold Layout(…).bytes. Launches on `stream`, allocates nothing,
// does not synchronise; returns cudaGetLastError(), or
// cudaErrorInvalidValue for a geometry outside these ranges or a smem below
// its layout.
int vaq_decoded_topk_scan(const void* rows, int64_t n, int d, const void* norms, const void* q,
                          int nq, int kk, int mt, int warps, int stages, int splits, int smem,
                          void* cand, void* bound, void* kept, void* stream) {
  // the splits' lowest keys bound the kk lowest once there are kk splits
  long long* mins = splits >= kk ? static_cast<long long*>(bound) + nq : nullptr;
  if (n <= 0 || nq <= 0 || d <= 0 || kk <= 0 || splits <= 0 || warps < 1 ||
      warps > MAX_WARPS || stages < 1 || stages > MAX_STAGES || (mt != 1 && mt != 2) ||
      n > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int dpad = (d + 15) / 16 * 16;
  if (static_cast<size_t>(smem) < Layout(stages, warps, 16 * mt, dpad + PAD, kk).bytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = (d % 8 == 0 && (reinterpret_cast<uintptr_t>(rows) & 15) == 0) ? 1 : 0;
  const auto st = static_cast<cudaStream_t>(stream);
  return mt == 2 ? launch_depth<2>(dpad, rows, n, d, norms, q, nq, kk, warps, stages, splits,
                                   smem, vec, cand, bound, mins, kept, st)
                 : launch_depth<1>(dpad, rows, n, d, norms, q, nq, kk, warps, stages, splits,
                                   smem, vec, cand, bound, mins, kept, st);
}

}  // extern "C"
