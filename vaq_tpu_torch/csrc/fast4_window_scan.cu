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
// sum, ties going to the lower row, as the JAX kernels pack it. K3 adds the
// bf16-rounded entries one subspace at a time with plain f32 adds (no
// multiply, so nothing to fuse; -O3 without fast-math keeps the order), so its
// keys equal the plain PyTorch version's (ops/scan_codes.py) bit for bit. K4's
// integer sums equal JAX's exactly. Rows at or past n_rows count as code 0,
// which is what the JAX caller's zero padding gives.
//
// The TPU kernels built a one-hot of the codes and multiplied it with the LUT
// on the MXU, because the MXU cannot gather. This first Hopper version is a
// shared-memory gather: a block takes 256 rows (one per thread) and a tile of
// queries, stages the rows' codes (256 × 64 B = 16 KB at M = 64) and the
// tile's LUT (K3: the f32 values of the bf16-rounded entries, 4 KB a query at
// M = 64, C = 16; K4: 1 KB a query) in shared memory, and each thread sums
// its row's M subspaces for up to 8 queries at a time in registers. The
// wrapper (ops/scan_codes.py, _fast4_tile) sizes the tile from M and C, so
// that C = 256 runs too: at most 64 KB of LUT and 32 queries, whole groups of
// 8, which lets two blocks share an SM. A warp whose 32 rows lie in one
// window takes its min by shuffles; windows then meet in a shared-memory
// atomicMin and, since a window may span blocks, one global atomicMin per
// (query, window) touched.
//
// What bounds it, at the main shape (M = 64, C = 16, 256-row windows, n padded
// to 1,001,472 rows, 512 queries), from the H100 SXM's published peaks at its
// 700 W limit: 64.1 MB of codes, 2.1 MB of f32 LUT (0.5 MB s8) and 8.0 MB of
// keys take 0.022 ms at 3.35 TB/s; the one-hot form, the fastest known, is
// 2·512·1,001,472·1024 = 1.05 T operations, 1.06 ms in bf16 (K3) and 0.53 ms
// in int8 (K4) on the tensor cores. This kernel instead issues one
// shared-memory load and one add per (row, query, subspace), 33 G of each:
// at one warp-wide load per clock per SM that is 7.9 M clocks an SM, 4.0 ms
// at the H100's 1980 MHz boost clock. A right, simple kernel is the goal of
// this version; register-resident LUTs (__byte_perm, the AVX2 pshufb analog),
// packed u8 SIMD adds and an int8 mma one-hot form are the levers for a
// later one.

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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
  extern __shared__ __align__(16) unsigned char smem[];
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

}  // namespace

extern "C" {

// codes (n_rows, m) u8; lut (nq, m, c) f32 (lut_int8 = 0, K3) or int8 (K4);
// keys (nq, n_win) int32 must hold INT_MAX on entry. q_tile and smem come from
// the wrapper's _fast4_tile. Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError().
int vaq_fast4_window_scan(const void* codes, int64_t n_rows, int m,
                          const void* lut, int lut_int8, int nq, int c,
                          int block_rows, int idx_bits, int64_t n_win,
                          int q_tile, int smem, void* keys, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lut_int8)
    return dispatch<int8_t>(codes, n_rows, m, lut, nq, c, block_rows, idx_bits,
                            n_win, q_tile, smem, keys, st);
  return dispatch<float>(codes, n_rows, m, lut, nq, c, block_rows, idx_bits,
                         n_win, q_tile, smem, keys, st);
}

}  // extern "C"
