// K1 — decode-then-dot window scan, the codes-resident tier's scan.
//
// Replaces vaq_tpu/ops/scan_pallas.py: decode_window_scan (:363) and its
// Pallas body _decode_score_kernel (:283). For every (query q, window of
// block_rows rows) it returns the window's smallest
//     dist = (‖x̂‖² − 2·q·x̂) + ‖q‖²,   clamped at 0,
// packed with the row into one int32 key: the f32 bits of dist with the low
// idx_bits replaced by the row's index inside its window. Non-negative f32
// bits order like the floats, so the min key is the min distance, ties going
// to the lower row, exactly as the JAX kernel packs it (scan_pallas.py:352-358).
// x̂ is decoded from u8 codes through the bf16-rounded decode table; q is
// bf16; the dot and ‖x̂‖² are summed in f32. Rows at or past n_rows decode as
// code 0, which is what the JAX caller's zero padding of the codes gives.
//
// What bounds it: about d multiply-adds per (row, query) — 2·512·1M·128 ≈
// 134 GFLOP per 512-query batch at n = 1M, d = 128 — against 32 MB of codes
// read. It is compute-bound. This first version runs those products on the
// f32 CUDA cores: each block decodes a 64-row tile into shared memory (one
// 32-column slice at a time), multiplies it with a 64-query tile, 4 × 4
// products per thread, and reduces each window with shared-memory atomicMin
// on the packed keys, then one global atomicMin per (query, window) that
// the tile touches (a window may span tiles). Tensor cores (mma.sync, then
// wgmma) are the lever for a later version.
//
// The TPU kernel's bf16-pair packed table, lane-replication matmul and
// (8, 128) tiling were Mosaic workarounds and have no counterpart here.

#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TR = 64;        // rows per block tile
constexpr int TQ = 64;        // queries per block tile
constexpr int DK = 32;        // decoded columns staged per step
constexpr int PAD = 4;        // keeps rows 16-byte aligned for float4 reads
constexpr int THREADS = 256;  // 16 × 16 threads, 4 rows × 4 queries each

__global__ void __launch_bounds__(THREADS)
decode_window_scan_kernel(const uint8_t* __restrict__ codes, int64_t n_rows,
                          int64_t n_total, int m,
                          const __nv_bfloat16* __restrict__ table,
                          const __nv_bfloat16* __restrict__ q,
                          const float* __restrict__ qn, int nq, int d, int l,
                          int block_rows, int idx_bits, int win_per_tile,
                          int64_t n_win, int32_t* __restrict__ keys) {
  __shared__ __align__(16) float xs[DK][TR + PAD];  // decoded rows, transposed
  __shared__ __align__(16) float qs[DK][TQ + PAD];  // queries, transposed
  __shared__ float norm_s[TR];
  extern __shared__ __align__(16) unsigned char dyn[];
  int32_t* wmin = reinterpret_cast<int32_t*>(dyn);  // [TQ][win_per_tile]
  uint8_t* codes_s = dyn + sizeof(int32_t) * TQ * win_per_tile;  // [m][TR]

  const int tid = threadIdx.x;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * TR;
  const int q0 = blockIdx.y * TQ;
  const int64_t w0 = r0 / block_rows;

  for (int i = tid; i < TQ * win_per_tile; i += THREADS) wmin[i] = INT_MAX;
  for (int i = tid; i < TR * m; i += THREADS) {
    const int r = i / m, s = i % m;
    const int64_t row = r0 + r;
    codes_s[s * TR + r] = row < n_rows ? codes[row * m + s] : 0;
  }
  __syncthreads();

  const int tr = tid / 16, tq = tid % 16;
  float acc[4][4] = {};
  float nrm = 0.f;
  for (int d0 = 0; d0 < d; d0 += DK) {
    const int dk = min(DK, d - d0);
    for (int i = tid; i < TR * DK; i += THREADS) {
      const int r = i % TR, kk = i / TR;
      float v = 0.f;
      if (kk < dk) {
        const int col = d0 + kk;
        const int code = codes_s[(col / l) * TR + r];
        v = __bfloat162float(table[static_cast<int64_t>(code) * d + col]);
      }
      xs[kk][r] = v;
    }
    for (int i = tid; i < TQ * DK; i += THREADS) {
      const int qq = i / DK, kk = i % DK;
      float v = 0.f;
      if (kk < dk && q0 + qq < nq)
        v = __bfloat162float(q[static_cast<int64_t>(q0 + qq) * d + d0 + kk]);
      qs[kk][qq] = v;
    }
    __syncthreads();
    // ‖x̂‖²: one thread per row, columns in order. Squares of bf16 values
    // are exact in f32, so the fused multiply-add rounds like mul then add.
    if (tid < TR) {
      for (int kk = 0; kk < dk; ++kk) nrm = __fmaf_rn(xs[kk][tid], xs[kk][tid], nrm);
    }
    for (int kk = 0; kk < dk; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[kk][tr * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&qs[kk][tq * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  if (tid < TR) norm_s[tid] = nrm;
  __syncthreads();

  const int32_t idx_mask = (1 << idx_bits) - 1;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int qq = tq * 4 + j;
    if (q0 + qq >= nq) continue;
    const float qnv = qn[q0 + qq];
    int32_t best = INT_MAX;
    int64_t bw = -1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = tr * 4 + i;
      const int64_t row = r0 + rl;
      if (row >= n_total) break;
      // (‖x̂‖² − 2·dot) + ‖q‖², rounded step by step as the JAX kernel does
      float dist = __fadd_rn(__fsub_rn(norm_s[rl], __fmul_rn(2.f, acc[i][j])), qnv);
      dist = dist > 0.f ? dist : 0.f;
      const int64_t w = row / block_rows;
      const int32_t key = (__float_as_int(dist) & ~idx_mask) |
                          static_cast<int32_t>(row - w * block_rows);
      if (w != bw) {
        if (bw >= 0) atomicMin(&wmin[qq * win_per_tile + (bw - w0)], best);
        bw = w;
        best = key;
      } else {
        best = min(best, key);
      }
    }
    if (bw >= 0) atomicMin(&wmin[qq * win_per_tile + (bw - w0)], best);
  }
  __syncthreads();
  for (int i = tid; i < TQ * win_per_tile; i += THREADS) {
    const int qq = i / win_per_tile, wl = i % win_per_tile;
    const int32_t v = wmin[i];
    // INT_MAX is a NaN bit pattern, never a real key: the slot went unused
    if (v != INT_MAX && q0 + qq < nq && w0 + wl < n_win)
      atomicMin(&keys[static_cast<int64_t>(q0 + qq) * n_win + w0 + wl], v);
  }
}

}  // namespace

extern "C" {

// keys (nq, n_win) int32 must hold INT_MAX on entry. Launches on `stream`,
// allocates nothing, does not synchronise; returns cudaGetLastError().
int vaq_decode_window_scan(const void* codes, int64_t n_rows, int m,
                           const void* table, const void* q, const void* qn,
                           int nq, int d, int block_rows, int idx_bits,
                           int64_t n_win, void* keys, void* stream) {
  const int64_t n_total = n_win * block_rows;
  const int win_per_tile = std::min(TR, (TR - 1) / block_rows + 2);
  const size_t dyn = sizeof(int32_t) * TQ * win_per_tile + static_cast<size_t>(TR) * m;
  // Above 48 KB a launch is refused unless the kernel opted in; the caller
  // checks the returned error, so a refusal is never silent.
  cudaFuncSetAttribute(decode_window_scan_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(dyn));
  const dim3 grid(static_cast<unsigned>((n_total + TR - 1) / TR),
                  static_cast<unsigned>((nq + TQ - 1) / TQ));
  decode_window_scan_kernel<<<grid, THREADS, dyn,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(codes), n_rows, n_total, m,
      static_cast<const __nv_bfloat16*>(table),
      static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(qn), nq,
      d, d / m, block_rows, idx_bits, win_per_tile, n_win,
      static_cast<int32_t*>(keys));
  return static_cast<int>(cudaGetLastError());
}

const char* vaq_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
