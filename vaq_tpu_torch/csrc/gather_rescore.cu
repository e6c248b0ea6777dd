// K7 — gather-rescore of the TI/IVF probe's winner windows.
//
// Replaces vaq_tpu/ops/rescore_pallas.py: gather_rescore (:175) with its
// Pallas bodies _kernel (:105, K7) and _kernel_t (:39, K8, the transposed
// layout of d % 128 != 0; here one row-major layout serves every d that is a
// multiple of 16). For query i and each of its m winner windows w =
// wblk[i][j] (rows [w·gs, (w+1)·gs) of the flat buckets) it writes, for
// every row x of the window,
//     out[i][j][r] = 2·(q_i · x) − Σ_d w_d·x_d²
// in f32, with q_i the bf16-rounded scale-folded query and x int8 or bf16.
// Products are exact in f32; the norm is summed in full f32 (on the TPU that
// took Precision.HIGHEST). A window id outside [0, n_blk) gives NaN rather
// than a read out of bounds; dead slots are masked by the caller.
//
// What bounds it: the gathered bytes. At the 1M shapes (512 queries, m = 200
// windows of gs = 8 int8 rows, d = 128) that is 105 MB read and 3.3 MB
// written, about 0.03 ms at 3.35 TB/s, against 52 MFLOP. The TPU kernel
// scalar-prefetched the window ids and double-buffered the slab DMAs across
// grid steps; here each block reads its own window ids and its warps stream
// whole rows (one coalesced 4-byte word per lane per step), with the query
// and the norm weights held in shared memory, and reduce with shuffles.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int SLOTS = 64;  // (window, row) pairs per block, 8 per warp

// One lane's share of q·x and Σ w·x² over a row, 4 bytes per step.
__device__ __forceinline__ void row_terms(const int8_t* row, int d, int lane,
                                          const float* q_s, const float* w_s,
                                          float& dot, float& nrm) {
  const char4* v4 = reinterpret_cast<const char4*>(row);
  for (int i = lane; i < d / 4; i += 32) {
    const char4 v = v4[i];
    const float4 q = reinterpret_cast<const float4*>(q_s)[i];
    const float4 w = reinterpret_cast<const float4*>(w_s)[i];
    const float x[4] = {static_cast<float>(v.x), static_cast<float>(v.y),
                        static_cast<float>(v.z), static_cast<float>(v.w)};
    const float qv[4] = {q.x, q.y, q.z, q.w};
    const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dot = __fmaf_rn(x[e], qv[e], dot);
      nrm = __fmaf_rn(x[e] * x[e], wv[e], nrm);
    }
  }
}

__device__ __forceinline__ void row_terms(const __nv_bfloat16* row, int d, int lane,
                                          const float* q_s, const float* w_s,
                                          float& dot, float& nrm) {
  const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(row);
  for (int i = lane; i < d / 2; i += 32) {
    const float2 x = __bfloat1622float2(v2[i]);
    const float2 q = reinterpret_cast<const float2*>(q_s)[i];
    const float2 w = reinterpret_cast<const float2*>(w_s)[i];
    dot = __fmaf_rn(x.x, q.x, dot);
    dot = __fmaf_rn(x.y, q.y, dot);
    nrm = __fmaf_rn(x.x * x.x, w.x, nrm);
    nrm = __fmaf_rn(x.y * x.y, w.y, nrm);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
gather_rescore_kernel(const __nv_bfloat16* __restrict__ q, const float* __restrict__ w,
                      const T* __restrict__ rows, int64_t n_blk,
                      const int32_t* __restrict__ wblk, int m, int gs, int d,
                      int tiles, float* __restrict__ out) {
  extern __shared__ __align__(16) float sh[];
  float* q_s = sh;      // [d] the query, widened
  float* w_s = sh + d;  // [d] the norm weights (d % 16 == 0 keeps it aligned)
  const int qi = blockIdx.x / tiles;
  const int64_t slot0 = static_cast<int64_t>(blockIdx.x % tiles) * SLOTS;
  for (int j = threadIdx.x; j < d; j += THREADS) {
    q_s[j] = __bfloat162float(q[static_cast<int64_t>(qi) * d + j]);
    w_s[j] = w[j];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t slots = static_cast<int64_t>(m) * gs;
  for (int s = warp; s < SLOTS; s += WARPS) {
    const int64_t slot = slot0 + s;
    if (slot >= slots) break;  // uniform across the warp
    const int64_t j = slot / gs;
    const int r = static_cast<int>(slot % gs);
    const int32_t wid = wblk[static_cast<int64_t>(qi) * m + j];
    float res = NAN;
    if (wid >= 0 && wid < n_blk) {  // uniform across the warp
      float dot = 0.f, nrm = 0.f;
      row_terms(rows + (static_cast<int64_t>(wid) * gs + r) * d, d, lane, q_s, w_s,
                dot, nrm);
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
        nrm += __shfl_xor_sync(0xffffffffu, nrm, off);
      }
      res = __fsub_rn(2.f * dot, nrm);
    }
    if (lane == 0) out[(static_cast<int64_t>(qi) * m + j) * gs + r] = res;
  }
}

}  // namespace

extern "C" {

// q (nq, d) bf16; w (d,) f32; rows (n_blk·gs, d) int8 (rows_int8 != 0) or
// bf16, 16-byte aligned; wblk (nq, m) int32; out (nq, m, gs) f32. Needs
// d % 16 == 0 (the wrapper checks). Launches on `stream`, allocates nothing,
// does not synchronise; returns cudaGetLastError().
int vaq_gather_rescore(const void* q, const void* w, const void* rows, int rows_int8,
                       int64_t n_blk, const void* wblk, int nq, int m, int gs,
                       int d, void* out, void* stream) {
  const int tiles = static_cast<int>((static_cast<int64_t>(m) * gs + SLOTS - 1) / SLOTS);
  const int64_t blocks = static_cast<int64_t>(nq) * tiles;
  const size_t dyn = 2 * sizeof(float) * static_cast<size_t>(d);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto qb = static_cast<const __nv_bfloat16*>(q);
  const auto wf = static_cast<const float*>(w);
  const auto wb = static_cast<const int32_t*>(wblk);
  const auto o = static_cast<float*>(out);
  if (blocks > 0) {
    // Above 48 KB (d > 6144) a launch is refused unless the kernel opted
    // in; the caller checks the returned error, so a refusal is never silent.
    if (rows_int8) {
      if (dyn > 48 * 1024)
        cudaFuncSetAttribute(gather_rescore_kernel<int8_t>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dyn));
      gather_rescore_kernel<int8_t><<<static_cast<unsigned>(blocks), THREADS, dyn, st>>>(
          qb, wf, static_cast<const int8_t*>(rows), n_blk, wb, m, gs, d, tiles, o);
    } else {
      if (dyn > 48 * 1024)
        cudaFuncSetAttribute(gather_rescore_kernel<__nv_bfloat16>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dyn));
      gather_rescore_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), THREADS, dyn,
                                             st>>>(
          qb, wf, static_cast<const __nv_bfloat16*>(rows), n_blk, wb, m, gs, d, tiles, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
