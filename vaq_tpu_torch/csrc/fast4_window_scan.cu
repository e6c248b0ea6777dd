// K3 and K4 — the FAST window scan over per-query lookup tables.
//
// Replaces vaq_tpu/ops/scan_pallas.py: fast4_window_scan (:192) and its two
// Pallas bodies, _fast4_kernel (:123, K3, f32 LUT) and _fast4_kernel_int8
// (:155, K4, the u8-quantized LUT shifted to s8). For every (query q, window
// of block_rows rows) it returns the window's smallest LUT sum
//     K3: acc = Σ_s bf16(lut[q, s, code_s]) in f32, s = 0 … M−1, clamped ≥ 0,
//         key = (bits(acc) & ~idx_mask) | local;
//     K4: acc = Σ_s lut8[q, s, code_s] in int32, key = (acc << idx_bits) | local,
// where local is the row's index inside its window. The min key is the min
// sum, ties going to the lower row, as the JAX kernels pack it. Rows at or
// past n_rows count as code 0, which is what the JAX caller's zero padding
// gives. K4's integer sums equal JAX's and the plain version's exactly.
//
// What bounds it, at the main shape (M = 64, C = 16, 256-row windows, n padded
// to 1,001,472 rows, 512 queries), from the H100 SXM's published peaks at its
// 700 W limit: 64.1 MB of codes, 2.1 MB of f32 LUT (0.5 MB s8) and 8.0 MB of
// keys take 0.022 ms at 3.35 TB/s; the one-hot product the TPU kernels ran on
// the MXU is 2·512·1,001,472·1024 = 1.05 T operations, 1.06 ms in bf16 (K3)
// and 0.53 ms in int8 (K4) on the tensor cores. The operations bound it. A
// shared-memory gather (one load and one add per row, query and subspace,
// 33 G of each) cannot get under about 4 ms however it is tiled, so this file
// has two forms, and the wrapper (ops/scan_codes.py, _fast4_form) picks one by
// a shape rule, "the query tile's LUT fits in shared memory":
//
// The tensor-core form (where it fits; the FAST configs, C = 16) computes
// the TPU kernels' product, one-hot(codes) · LUT, with wgmma:
// - Rows are the M dimension. A warpgroup takes 64-row tiles; each k step
//   (16 bf16 or 32 s8 columns of K = M·C) builds its one-hot A fragment in
//   registers from the rows' codes: shl.b32 of the element 1 (0x3F80 for
//   bf16, 1 for s8) by (code − column)·bits, which PTX clamps to 0 for a
//   code outside the register's columns. The 0/1 matrix never touches
//   shared or device memory. At C = 16 a row's codes for four steps are one
//   shared-memory load. Steps go four at a time, two register sets in
//   turn, so one set is built while the other's steps run.
// - The query tile's LUT is B (64 queries bf16 for K3, 128 s8 for K4, 128 KB
//   at M = 64, C = 16), staged once per block and read by descriptor,
//   K-major without swizzle. The wrapper lays it out already in 8-query ×
//   16-byte core matrices, bf16-rounded and zero-padded in K (to whole
//   groups of steps) and in queries (to the tile), so the block only copies
//   it. Shared memory then serves only B's reads and the codes' bytes.
// - Each warp copies its own 16 rows of each tile's codes by cp.async into a
//   ring four tiles deep (zero-filled past n_rows), so warps wait on nothing
//   but their own copies.
// - The grid holds whole sets of query tiles, each block keeping one tile
//   for its life, so the blocks of one row range run side by side and read
//   the codes from L2. A block holds four warpgroups for K3 and three for K4
//   (the most the registers allow: ptxas gives 126-127 and 167 a thread, no
//   spills): each waits on its own wgmmas, so the others keep the tensor
//   cores busy meanwhile. Fewer took longer, and so did two row tiles in
//   hand per warpgroup (timed on an H100).
// - Epilogue from the accumulators: keys of the two rows a lane holds, a
//   reduce-scatter over the eight lanes of a column that leaves each lane
//   N/32 columns, a running minimum over the tiles of a window (a warpgroup
//   takes whole windows when block_rows is a multiple of 64), then the four
//   warps meet in shared memory and each (query, window) is stored once.
//   Other window sizes take one atomicMin per row pair instead.
// K3's k steps each add one bf16 entry (the only nonzero product of the
// step) to the f32 accumulator, in subspace order, but the tensor cores do
// not round that addition to nearest: on an H100 they truncate it
// (scan_codes.k3_accumulation_rounding, run by chip_smoke.py and
// tests/test_torch_kernels_gpu.py). So this form's K3 keys agree with the
// plain version's to the packed-key tolerance, 1e-5 + 2^(idx_bits − 23)
// relative, not bit for bit, and a window's winner differs only where two
// rows' sums agree to that. What bounds this form now is the bf16 products
// at N = 64 (K3) and the epilogue that follows each tile
// (scripts/fast4_breakdown.py times copies with each part cut).
//
// The gather form (a wide table: at M = 32, C = 256 one 64-query bf16 tile
// is 1 MB) is the first Hopper version: a block takes 256 rows (one per
// thread) and a tile of queries, stages the rows' codes and the tile's LUT
// (K3: the f32 values of the bf16-rounded entries; K4: s8) in shared memory,
// and each thread sums its row's M subspaces for up to 8 queries at a time in
// registers, adding one subspace at a time with __fadd_rn (bit-equal to the
// plain version). The wrapper's _fast4_tile sizes the tile: at most 64 KB of
// LUT and 32 queries, whole groups of 8, so two blocks share an SM. A warp
// whose 32 rows lie in one window takes its min by shuffles; windows then
// meet in a shared-memory atomicMin and, since a window may span blocks, one
// global atomicMin per (query, window) touched. At C = 256 the one-hot
// product would do 16× the work of C = 16 for the same rows, and the gather
// beats it there.

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// The gather form.
constexpr int ROWS = 256;  // rows per block, one per thread
constexpr int THREADS = ROWS;

template <typename T>
struct Lut;

template <>
struct Lut<float> {  // K3
  using Acc = float;
  __device__ static float stage(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ static float add(float acc, float v) { return __fadd_rn(acc, v); }
  __device__ static int32_t key(float acc, int idx_bits, int32_t local) {
    const float a = acc > 0.f ? acc : 0.f;
    return (__float_as_int(a) & ~((1 << idx_bits) - 1)) | local;
  }
};

template <>
struct Lut<int8_t> {  // K4
  using Acc = int32_t;
  __device__ static int8_t stage(int8_t v) { return v; }
  __device__ static int32_t add(int32_t acc, int8_t v) { return acc + v; }
  __device__ static int32_t key(int32_t acc, int idx_bits, int32_t local) {
    // |acc| ≤ 128·M and M·2^idx_bits ≤ 2^24 (checked by the caller): the
    // shift cannot overflow; done on the unsigned bits, it is defined for
    // negative sums too and orders like the sum
    return static_cast<int32_t>(static_cast<uint32_t>(acc) << idx_bits) | local;
  }
};

template <typename T, int QJ>
__global__ void __launch_bounds__(THREADS)
fast4_window_scan_kernel(const uint8_t* __restrict__ codes, int64_t n_rows,
                         int64_t n_total, int m, const T* __restrict__ lut,
                         int nq, int c, int block_rows, int idx_bits,
                         int64_t n_win, int q_tile, int words, int win_per_tile,
                         int32_t* __restrict__ keys) {
  using Acc = typename Lut<T>::Acc;
  extern __shared__ __align__(1024) unsigned char smem[];
  // codes_s: [ROWS][words] 32-bit words, 4 codes each; an odd row stride
  // keeps the 32 rows of a warp in 32 different banks
  uint32_t* codes_s = reinterpret_cast<uint32_t*>(smem);
  int32_t* wmin = reinterpret_cast<int32_t*>(codes_s + ROWS * words);  // [q_tile][win_per_tile]
  T* lut_s = reinterpret_cast<T*>(wmin + q_tile * win_per_tile);      // [q_tile][m][c]

  const int tid = threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * ROWS;
  const int q0 = blockIdx.y * q_tile;
  const int qt = min(q_tile, nq - q0);
  const int64_t w0 = r0 / block_rows;
  const int mc = m * c;

  unsigned char* code_bytes = reinterpret_cast<unsigned char*>(codes_s);
  for (int i = tid; i < ROWS * m; i += THREADS) {
    const int r = i / m, s = i - r * m;
    const int64_t row = r0 + r;
    code_bytes[r * words * 4 + s] = row < n_rows ? codes[r0 * m + i] : 0;
  }
  for (int i = tid; i < qt * win_per_tile; i += THREADS) wmin[i] = INT_MAX;
  const T* lut_q = lut + static_cast<int64_t>(q0) * mc;
  if (sizeof(T) == 1 && (mc & 3) == 0) {  // s8 tables: four entries a load
    const uint32_t* src = reinterpret_cast<const uint32_t*>(lut_q);
    uint32_t* dst = reinterpret_cast<uint32_t*>(lut_s);
    for (int i = tid; i < qt * mc / 4; i += THREADS) dst[i] = src[i];
  } else {
    for (int i = tid; i < qt * mc; i += THREADS) lut_s[i] = Lut<T>::stage(lut_q[i]);
  }
  __syncthreads();

  const int64_t row = r0 + tid;
  const bool live = row < n_total;
  const int64_t w = row / block_rows;
  const int32_t local = static_cast<int32_t>(row - w * block_rows);
  const int slot = static_cast<int>(w - w0);
  const int64_t warp_row0 = r0 + (tid & ~31);
  const bool one_window = warp_row0 + 31 < n_total &&
                          warp_row0 / block_rows == (warp_row0 + 31) / block_rows;
  const uint32_t* my_codes = codes_s + tid * words;
  const int m4 = m >> 2;

  for (int j0 = 0; j0 < qt; j0 += QJ) {
    int off[QJ];
    Acc acc[QJ];
#pragma unroll
    for (int j = 0; j < QJ; ++j) {
      off[j] = min(j0 + j, qt - 1) * mc;  // spare slots redo the last query
      acc[j] = Acc(0);
    }
    int sc = 0;  // s·c
    for (int s4 = 0; s4 < m4; ++s4) {
      const uint32_t word = my_codes[s4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int e = sc + static_cast<int>((word >> (8 * b)) & 0xFFu);
#pragma unroll
        for (int j = 0; j < QJ; ++j) acc[j] = Lut<T>::add(acc[j], lut_s[off[j] + e]);
        sc += c;
      }
    }
    if (m & 3) {
      const uint32_t word = my_codes[m4];
      for (int b = 0; b < (m & 3); ++b) {
        const int e = sc + static_cast<int>((word >> (8 * b)) & 0xFFu);
#pragma unroll
        for (int j = 0; j < QJ; ++j) acc[j] = Lut<T>::add(acc[j], lut_s[off[j] + e]);
        sc += c;
      }
    }
#pragma unroll
    for (int j = 0; j < QJ; ++j) {
      if (j0 + j >= qt) break;
      int32_t key = Lut<T>::key(acc[j], idx_bits, local);
      if (one_window) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) key = min(key, __shfl_xor_sync(0xffffffffu, key, o));
        if ((tid & 31) == 0) atomicMin(&wmin[(j0 + j) * win_per_tile + slot], key);
      } else if (live) {
        atomicMin(&wmin[(j0 + j) * win_per_tile + slot], key);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < qt * win_per_tile; i += THREADS) {
    const int j = i / win_per_tile;
    const int64_t wg = w0 + (i - j * win_per_tile);
    const int32_t v = wmin[i];
    // INT_MAX is no key of either kernel (a NaN pattern for K3, above
    // 127·2^24 for K4): the slot went unused
    if (v != INT_MAX && wg < n_win)
      atomicMin(&keys[static_cast<int64_t>(q0 + j) * n_win + wg], v);
  }
}

template <typename T, int QJ>
int launch(const void* codes, int64_t n_rows, int m, const void* lut, int nq,
           int c, int block_rows, int idx_bits, int64_t n_win, int q_tile,
           int smem, void* keys, cudaStream_t stream) {
  const int64_t n_total = n_win * block_rows;
  const int words = ((m + 3) / 4) | 1;
  const int win_per_tile = std::min(ROWS, (ROWS - 1) / block_rows + 2);
  auto kernel = fast4_window_scan_kernel<T, QJ>;
  // Above 48 KB a launch is refused unless the kernel opted in; the caller
  // checks the returned error, so a refusal is never silent.
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid(static_cast<unsigned>((n_total + ROWS - 1) / ROWS),
                  static_cast<unsigned>((nq + q_tile - 1) / q_tile));
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const uint8_t*>(codes), n_rows, n_total, m,
      static_cast<const T*>(lut), nq, c, block_rows, idx_bits, n_win, q_tile,
      words, win_per_tile, static_cast<int32_t*>(keys));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* codes, int64_t n_rows, int m, const void* lut, int nq,
             int c, int block_rows, int idx_bits, int64_t n_win, int q_tile,
             int smem, void* keys, cudaStream_t stream) {
  // queries summed at once per thread: as many as the tile has, up to 8
  if (q_tile >= 8)
    return launch<T, 8>(codes, n_rows, m, lut, nq, c, block_rows, idx_bits,
                        n_win, q_tile, smem, keys, stream);
  if (q_tile >= 4)
    return launch<T, 4>(codes, n_rows, m, lut, nq, c, block_rows, idx_bits,
                        n_win, q_tile, smem, keys, stream);
  if (q_tile >= 2)
    return launch<T, 2>(codes, n_rows, m, lut, nq, c, block_rows, idx_bits,
                        n_win, q_tile, smem, keys, stream);
  return launch<T, 1>(codes, n_rows, m, lut, nq, c, block_rows, idx_bits,
                      n_win, q_tile, smem, keys, stream);
}


// ---------------------------------------------------------------------------
// The tensor-core form.

constexpr int MMA_TILE = 64;                 // rows a tile (the wgmma M)
constexpr int MMA_RING = 4;                  // code tiles in each warp's ring
constexpr int MMA_GROUP = 4;                 // k steps built and issued at once

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d_s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d_s),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// `one` shifted left by `amount`, 0 once the amount reaches 32: PTX clamps
// shl.b32's shift (unsigned) to the register width, so a negative amount
// (a code below the register's columns) gives 0 too.
__device__ __forceinline__ uint32_t shl_clamped(uint32_t one, int amount) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;\n" : "=r"(r) : "r"(one), "r"(amount));
  return r;
}

// Keeps a register's value alive, and in place, up to this point: the
// registers a wgmma reads or writes may not be reused before its wait.
__device__ __forceinline__ void keep(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void keep(int32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void keep(float& r) { asm volatile("" : "+f"(r)::"memory"); }

template <int P, typename T>
__device__ __forceinline__ void keep_all(T (&r)[P]) {
#pragma unroll
  for (int i = 0; i < P; ++i) keep(r[i]);
}

// The wgmma descriptor of a K-major no-swizzle operand at `p`: LBO 128 bytes
// (the next core matrix along K), SBO `sbo` bytes (the next 8 rows).
__device__ __forceinline__ uint64_t core_desc(const void* p, int sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

template <bool INT8>
struct Mma;

template <>
struct Mma<false> {  // K3: bf16 one-hot × bf16 LUT, f32 sums, 64 queries
  using Acc = float;
  static constexpr int N = 64, KSTEP = 16, NACC = 32, WGS = 4;  // WGS: warpgroups a block
  // d (32 f32 a thread) += A (64 rows × 16, registers) · B (64 queries ×
  // 16, descriptor db)ᵀ; d is overwritten where accumulate is 0.
  __device__ static void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                             int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
  // A fragment of k step j (columns 16j … 16j + 15) for rows g (cg) and
  // g + 8 (ch): a0 (g, 2t, 2t+1), a1 (g+8, same), a2 (g, 2t+8, 2t+9), a3
  // (g+8, same), the lower column in the low half.
  __device__ static void frag(uint32_t (&a)[4], const unsigned char* cg,
                              const unsigned char* ch, int j, int t, int lc, int cmask) {
    const int k0 = 16 * j + 2 * t, s = k0 >> lc, off = k0 & cmask;
    const int xg = static_cast<int>(cg[s]) - off, xh = static_cast<int>(ch[s]) - off;
    a[0] = shl_clamped(0x3F80u, 16 * xg);
    a[1] = shl_clamped(0x3F80u, 16 * xh);
    a[2] = shl_clamped(0x3F80u, 16 * (xg - 8));
    a[3] = shl_clamped(0x3F80u, 16 * (xh - 8));
  }
  // The same at C = 16, where step j is subspace j: the codes of rows g and
  // g + 8 in the low bytes of cg, ch; the shift is 16·(code − 2t).
  __device__ static void frag16(uint32_t (&a)[4], uint32_t cg, uint32_t ch, int t) {
    const int xg = 16 * static_cast<int>(cg) - 32 * t, xh = 16 * static_cast<int>(ch) - 32 * t;
    a[0] = shl_clamped(0x3F80u, xg);
    a[1] = shl_clamped(0x3F80u, xh);
    a[2] = shl_clamped(0x3F80u, xg - 128);
    a[3] = shl_clamped(0x3F80u, xh - 128);
  }
  __device__ static int32_t key(float acc, int idx_bits, int32_t local) {
    const float v = acc > 0.f ? acc : 0.f;
    return (__float_as_int(v) & ~((1 << idx_bits) - 1)) | local;
  }
};

template <>
struct Mma<true> {  // K4: s8 one-hot × s8 LUT, s32 sums, 128 queries
  using Acc = int32_t;
  static constexpr int N = 128, KSTEP = 32, NACC = 64, WGS = 3;
  __device__ static void mma(int32_t (&d)[64], const uint32_t (&a)[4], uint64_t db,
                             int accumulate) {
    asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
  // A fragment of k step j (columns 32j … 32j + 31): a0 (g, 4t … 4t+3), a1
  // (g+8, same), a2 (g, 16+4t … 16+4t+3), a3 (g+8, same), the lowest column
  // in the lowest byte. At C = 16 the two halves are two subspaces.
  __device__ static void frag(uint32_t (&a)[4], const unsigned char* cg,
                              const unsigned char* ch, int j, int t, int lc, int cmask) {
    const int k0 = 32 * j + 4 * t, s0 = k0 >> lc, off0 = k0 & cmask;
    const int k2 = k0 + 16, s2 = k2 >> lc, off2 = k2 & cmask;
    a[0] = shl_clamped(1u, 8 * (static_cast<int>(cg[s0]) - off0));
    a[1] = shl_clamped(1u, 8 * (static_cast<int>(ch[s0]) - off0));
    a[2] = shl_clamped(1u, 8 * (static_cast<int>(cg[s2]) - off2));
    a[3] = shl_clamped(1u, 8 * (static_cast<int>(ch[s2]) - off2));
  }
  // The same at C = 16, where step j is subspaces 2j (codes g0, h0 of rows g
  // and g + 8) and 2j + 1 (g1, h1); the shift is 8·(code − 4t).
  __device__ static void frag16(uint32_t (&a)[4], uint32_t g0, uint32_t h0, uint32_t g1,
                                uint32_t h1, int t) {
    a[0] = shl_clamped(1u, 8 * static_cast<int>(g0) - 32 * t);
    a[1] = shl_clamped(1u, 8 * static_cast<int>(h0) - 32 * t);
    a[2] = shl_clamped(1u, 8 * static_cast<int>(g1) - 32 * t);
    a[3] = shl_clamped(1u, 8 * static_cast<int>(h1) - 32 * t);
  }
  __device__ static int32_t key(int32_t acc, int idx_bits, int32_t local) {
    // |acc| ≤ 128·M and M·2^idx_bits ≤ 2^24 (checked by the caller): the
    // shift cannot overflow; on the unsigned bits it is defined for negative
    // sums too and orders like the sum
    return static_cast<int32_t>(static_cast<uint32_t>(acc) << idx_bits) | local;
  }
};

// Byte i of w, zero-extended.
__device__ __forceinline__ uint32_t byte_of(uint32_t w, int i) {
  return __byte_perm(w, 0u, 0x4440u | static_cast<uint32_t>(i));
}

// Steps [MMA_GROUP·grp, MMA_GROUP·(grp + 1)) of one tile: build the group's
// A fragments, then issue its wgmmas as one commit group. At C = 16 (C16)
// the group's codes are one 4-byte word a row (K3: four subspaces) or two
// (K4: eight), loaded at once.
template <bool INT8, bool C16>
__device__ __forceinline__ void mma_group(typename Mma<INT8>::Acc (&acc)[Mma<INT8>::NACC],
                                          uint32_t (&a)[MMA_GROUP][4], int grp,
                                          const unsigned char* cg, const unsigned char* ch,
                                          int t, int lc, int cmask, uint64_t db0) {
  if constexpr (C16 && !INT8) {
    const uint32_t wg_ = *reinterpret_cast<const uint32_t*>(cg + 4 * grp);
    const uint32_t wh_ = *reinterpret_cast<const uint32_t*>(ch + 4 * grp);
#pragma unroll
    for (int i = 0; i < MMA_GROUP; ++i)
      Mma<false>::frag16(a[i], byte_of(wg_, i), byte_of(wh_, i), t);
  } else if constexpr (C16) {
    const uint2 wg_ = *reinterpret_cast<const uint2*>(cg + 8 * grp);
    const uint2 wh_ = *reinterpret_cast<const uint2*>(ch + 8 * grp);
#pragma unroll
    for (int i = 0; i < MMA_GROUP; ++i) {
      const uint32_t xg = i < 2 ? wg_.x : wg_.y, xh = i < 2 ? wh_.x : wh_.y;
      const int b = (2 * i) & 3;
      Mma<true>::frag16(a[i], byte_of(xg, b), byte_of(xh, b), byte_of(xg, b + 1),
                        byte_of(xh, b + 1), t);
    }
  } else {
#pragma unroll
    for (int i = 0; i < MMA_GROUP; ++i)
      Mma<INT8>::frag(a[i], cg, ch, grp * MMA_GROUP + i, t, lc, cmask);
  }
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < MMA_GROUP; ++i) {
    const int j = grp * MMA_GROUP + i;
    // each k step: the next two core matrices along K (256 bytes, 16 in
    // the descriptor's units)
    Mma<INT8>::mma(acc, a[i], db0 + 16 * j, j > 0);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void keep_frags(uint32_t (&a)[MMA_GROUP][4]) {
#pragma unroll
  for (int i = 0; i < MMA_GROUP; ++i) keep_all(a[i]);
}

// One block: one query tile (blockIdx.x % n_qt), its LUT staged once; each
// warpgroup walks its units (whole windows when block_rows % 64 == 0, else
// single 64-row tiles), n_wg warpgroups a query tile sharing them out.
// Shared memory: the tile's LUT (tile_bytes), each warp's code ring
// (MMA_RING × 16 rows × ms bytes), and two buffers of 4 × N window minima per
// warpgroup.
template <bool INT8, bool C16>
__global__ void __launch_bounds__(128 * Mma<INT8>::WGS, 1)
fast4_mma_kernel(const uint8_t* __restrict__ codes, int64_t n_rows, int m, int ms,
                 bool aligned_codes, const unsigned char* __restrict__ tiles, int tile_bytes,
                 int kpad, int lc, int nq, int n_qt, int block_rows, int idx_bits,
                 int64_t n_win, int32_t* __restrict__ keys) {
  using T = Mma<INT8>;
  using Acc = typename T::Acc;
  constexpr int N = T::N, MMA_WGS = T::WGS, MMA_THREADS = 128 * T::WGS;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* b_s = smem;
  unsigned char* ring = smem + tile_bytes;
  int32_t* wmin = reinterpret_cast<int32_t*>(ring + MMA_WGS * 4 * MMA_RING * 16 * ms);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int qt = blockIdx.x % n_qt, q0 = qt * N;
  const int n_wg = static_cast<int>(gridDim.x / n_qt) * MMA_WGS;
  const int wg_id = static_cast<int>(blockIdx.x / n_qt) * MMA_WGS + wg;

  // the query tile's LUT, already in core-matrix order
  const unsigned char* src = tiles + static_cast<int64_t>(qt) * tile_bytes;
  for (int i = tid * 16; i < tile_bytes; i += MMA_THREADS * 16) cp_async16(b_s + i, src + i, 16);
  cp_async_commit();
  cp_async_wait<0>();
  fence_async_smem();  // the staged LUT is for wgmma
  __syncthreads();

  const int64_t n_total = n_win * block_rows;
  const bool win_units = block_rows % MMA_TILE == 0;
  const int tpu = win_units ? block_rows / MMA_TILE : 1;  // tiles a unit
  const int64_t n_units = win_units ? n_win : (n_total + MMA_TILE - 1) / MMA_TILE;
  const int64_t unit_rows = win_units ? block_rows : MMA_TILE;
  // the first row of this warpgroup's f-th tile, or −1 past its last
  auto tile_row0 = [&](int64_t f) -> int64_t {
    const int64_t u = wg_id + (f / tpu) * n_wg;
    return u < n_units ? u * unit_rows + (f % tpu) * MMA_TILE : -1;
  };
  unsigned char* my_ring = ring + warp * MMA_RING * 16 * ms;
  // the warp's 16 rows of tile f into its ring slot; one commit group,
  // empty past the last tile
  auto fetch = [&](int64_t f) {
    const int64_t r0 = tile_row0(f);
    if (r0 >= 0) {
      unsigned char* dst = my_ring + (f % MMA_RING) * 16 * ms;
      const int64_t w0 = r0 + wq * 16;
      if (aligned_codes) {
        const int cpr = m / 16;
        for (int i = lane; i < 16 * cpr; i += 32) {
          const int r = i / cpr, j = i - r * cpr;
          const bool ok = w0 + r < n_rows;
          cp_async16(dst + r * ms + 16 * j, ok ? codes + (w0 + r) * m + 16 * j : codes,
                     ok ? 16 : 0);
        }
      } else {
        for (int i = lane; i < 16 * m; i += 32) {
          const int r = i / m, s = i - r * m;
          dst[r * ms + s] = w0 + r < n_rows ? codes[(w0 + r) * m + s] : 0;
        }
      }
    }
    cp_async_commit();
  };

  const int cmask = (1 << lc) - 1;
  const int ngrp = kpad / (T::KSTEP * MMA_GROUP);
  const uint64_t db0 = core_desc(b_s, 8 * kpad * (INT8 ? 1 : 2));
  constexpr int NK = N / 32;  // window minima a lane keeps
  int32_t run[NK];
  int parity = 0;
  for (int v = 0; v < MMA_RING - 1; ++v) fetch(v);
  for (int64_t f = 0;; ++f) {
    const int64_t r0 = tile_row0(f);
    if (r0 < 0) break;
    cp_async_wait<MMA_RING - 2>();  // this lane's copies of tile f have landed
    __syncwarp();                   // and the other lanes'
    const unsigned char* cg = my_ring + (f % MMA_RING) * 16 * ms + g * ms;
    const unsigned char* ch = cg + 8 * ms;

    Acc acc[T::NACC];
    uint32_t a0[MMA_GROUP][4], a1[MMA_GROUP][4];
    mma_group<INT8, C16>(acc, a0, 0, cg, ch, t, lc, cmask, db0);
    for (int grp = 1; grp < ngrp; grp += 2) {
      mma_group<INT8, C16>(acc, a1, grp, cg, ch, t, lc, cmask, db0);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      keep_frags(a0);  // a0's steps are done: its registers may be rebuilt
      if (grp + 1 >= ngrp) break;
      mma_group<INT8, C16>(acc, a0, grp + 1, cg, ch, t, lc, cmask, db0);
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      keep_frags(a1);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    keep_frags(a0);
    keep_frags(a1);
    keep_all(acc);
    __syncwarp();
    fetch(f + MMA_RING - 1);  // into the slot of tile f − 1, read by now

    // Epilogue. Lane (g, t) holds rows g and g + 8 of the warp's 16, columns
    // 8i + 2t + e of n-tile i in acc[4i + e] and acc[4i + 2 + e].
    const int64_t row_g = r0 + wq * 16 + g;
    if (win_units) {
      const int32_t lg = static_cast<int32_t>(row_g % block_rows);
      int32_t mk[N / 4];
#pragma unroll
      for (int i = 0; i < N / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          mk[2 * i + e] = min(T::key(acc[4 * i + e], idx_bits, lg),
                              T::key(acc[4 * i + 2 + e], idx_bits, lg + 8));
      // reduce-scatter over the eight lanes of a column (lane bits 4, 3, 2
      // are g's bits 2, 1, 0): each lane keeps mk[g·N/32 … g·N/32 + N/32)
      int32_t h1[N / 8];
      const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
      for (int i = 0; i < N / 8; ++i)
        h1[i] = min(b4 ? mk[N / 8 + i] : mk[i],
                    __shfl_xor_sync(0xffffffffu, b4 ? mk[i] : mk[N / 8 + i], 16));
      int32_t h2[N / 16];
#pragma unroll
      for (int i = 0; i < N / 16; ++i)
        h2[i] = min(b3 ? h1[N / 16 + i] : h1[i],
                    __shfl_xor_sync(0xffffffffu, b3 ? h1[i] : h1[N / 16 + i], 8));
      const bool first = r0 % block_rows == 0;
#pragma unroll
      for (int i = 0; i < NK; ++i) {
        const int32_t v = min(b2 ? h2[NK + i] : h2[i],
                              __shfl_xor_sync(0xffffffffu, b2 ? h2[i] : h2[NK + i], 4));
        run[i] = first ? v : min(run[i], v);
      }
      if ((r0 + MMA_TILE) % block_rows == 0) {  // the window's last tile
        int32_t* buf = wmin + (wg * 2 + parity) * 4 * N;
#pragma unroll
        for (int i = 0; i < NK; ++i) {
          const int p = g * NK + i;  // mk index: column 8·(p / 2) + 2t + p % 2
          buf[wq * N + 8 * (p >> 1) + 2 * t + (p & 1)] = run[i];
        }
        bar_sync(1 + wg, 128);
        const int col = tid & 127;
        if (col < N && q0 + col < nq) {
          const int32_t v = min(min(buf[col], buf[N + col]), min(buf[2 * N + col], buf[3 * N + col]));
          keys[static_cast<int64_t>(q0 + col) * n_win + r0 / block_rows] = v;
        }
        parity ^= 1;
      }
    } else {
      // windows that do not hold whole tiles: the min of a lane's two rows
      // where they share a window, then one atomicMin a row
      const int64_t row_h = row_g + 8;
      const int64_t wgw = row_g / block_rows, whw = row_h / block_rows;
      const int32_t lg = static_cast<int32_t>(row_g - wgw * block_rows);
      const int32_t lh = static_cast<int32_t>(row_h - whw * block_rows);
      const bool live_g = row_g < n_total, live_h = row_h < n_total, same = wgw == whw;
#pragma unroll
      for (int i = 0; i < N / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = q0 + 8 * i + 2 * t + e;
          if (q >= nq) continue;
          int32_t kg = T::key(acc[4 * i + e], idx_bits, lg);
          const int32_t kh = T::key(acc[4 * i + 2 + e], idx_bits, lh);
          int32_t* kq = keys + static_cast<int64_t>(q) * n_win;
          if (same && live_h) kg = min(kg, kh);
          else if (live_h) atomicMin(kq + whw, kh);
          if (live_g) atomicMin(kq + wgw, kg);
        }
    }
  }
  cp_async_wait<0>();
}

template <bool INT8>
int mma_smem_bytes(int kpad, int ms) {
  constexpr int n = Mma<INT8>::N, wgs = Mma<INT8>::WGS;
  return n * kpad * (INT8 ? 1 : 2) + wgs * 4 * MMA_RING * 16 * ms + wgs * 2 * 4 * n * 4;
}

template <bool INT8>
int launch_mma(const void* codes, int64_t n_rows, int m, const void* tiles, int nq, int c,
               int kpad, int block_rows, int idx_bits, int64_t n_win, int smem, void* keys,
               cudaStream_t stream) {
  constexpr int N = Mma<INT8>::N;
  const int ms = ((m + 15) / 16 * 16) | 16;  // an odd count of 16 bytes: no bank conflicts
  int lc = 0;
  while ((1 << lc) < c) ++lc;
  // the wrapper sizes the same layout (scan_codes._fast4_form); a mismatch
  // is refused, never run
  if (smem != mma_smem_bytes<INT8>(kpad, ms) || (1 << lc) != c || c < 16 ||
      kpad % (Mma<INT8>::KSTEP * MMA_GROUP) != 0 || kpad / c > ms)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_qt = (nq + N - 1) / N;
  int dev = 0, n_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  // whole sets of query tiles: block b keeps tile b % n_qt
  const int per_qt = std::max(1, n_sm / n_qt);
  const bool aligned_codes = m % 16 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  auto kernel = c == 16 ? fast4_mma_kernel<INT8, true> : fast4_mma_kernel<INT8, false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<static_cast<unsigned>(per_qt * n_qt), 128 * Mma<INT8>::WGS, smem, stream>>>(
      static_cast<const uint8_t*>(codes), n_rows, m, ms, aligned_codes,
      static_cast<const unsigned char*>(tiles), N * kpad * (INT8 ? 1 : 2), kpad, lc, nq, n_qt,
      block_rows, idx_bits, n_win, static_cast<int32_t*>(keys));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// codes (n_rows, m) u8; keys (nq, n_win) int32 must hold INT_MAX on entry.
// The gather form (tiles null): lut (nq, m, c) f32 (lut_int8 = 0, K3) or
// int8 (K4); q_tile and smem from the wrapper's _fast4_tile. The tensor-core
// form (tiles given): c ≥ 16, tiles the LUT in core-matrix order as the
// wrapper's _fast4_lut_tiles lays it out, kpad its padded K, smem from
// _fast4_form (q_tile unused). Launches on `stream`, allocates nothing, does
// not synchronise; returns cudaGetLastError().
int vaq_fast4_window_scan(const void* codes, int64_t n_rows, int m,
                          const void* lut, int lut_int8, int nq, int c,
                          int block_rows, int idx_bits, int64_t n_win,
                          int q_tile, int smem, const void* tiles, int kpad,
                          void* keys, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tiles != nullptr) {
    if (lut_int8)
      return launch_mma<true>(codes, n_rows, m, tiles, nq, c, kpad, block_rows, idx_bits,
                              n_win, smem, keys, st);
    return launch_mma<false>(codes, n_rows, m, tiles, nq, c, kpad, block_rows, idx_bits,
                             n_win, smem, keys, st);
  }
  if (lut_int8)
    return dispatch<int8_t>(codes, n_rows, m, lut, nq, c, block_rows, idx_bits,
                            n_win, q_tile, smem, keys, st);
  return dispatch<float>(codes, n_rows, m, lut, nq, c, block_rows, idx_bits,
                         n_win, q_tile, smem, keys, st);
}

}  // extern "C"
