// K2 — exact f32 rescore of the codes tier's window winners.
//
// Replaces vaq_tpu/ops/scan_pallas.py: decode_rescore (:512) and its Pallas
// body _decode_dist_kernel (:477), fused with the XLA gather and the query
// broadcast around it (scan_pallas.py:620-624): for each query i and each of
// its kk candidate row ids it reads the candidate's u8 codes straight from
// the (n, M) codes array and returns
//     Σ_j (q_i[j] − rows[code_{j/L}][j])²   in f32,
// with x̂ built from the f32 decode rows, and +inf for id −1 (or any id
// outside [0, n_rows)). The fusion matters: the unfused form builds a
// q_rep of nq·kk·d floats, about 100 MB per 512-query batch.
//
// What bounds it: nq·kk gathers of M code bytes and d table floats (the
// 256 × 128 f32 table stays in L1/L2), ~100k candidates per batch — a few
// MB moved, so launch latency and gather latency, not FLOPs. One warp per
// candidate: lanes stride the d columns, then a shuffle reduction.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__global__ void __launch_bounds__(THREADS)
decode_rescore_kernel(const uint8_t* __restrict__ codes, int64_t n_rows, int m,
                      const int32_t* __restrict__ cand, int64_t n_cand, int kk,
                      const float* __restrict__ rows,
                      const float* __restrict__ qp, int d, int l,
                      float* __restrict__ out) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (c >= n_cand) return;  // uniform across the warp
  const int32_t id = cand[c];
  if (id < 0 || id >= n_rows) {  // uniform across the warp
    if (lane == 0) out[c] = INFINITY;
    return;
  }
  const uint8_t* crow = codes + static_cast<int64_t>(id) * m;
  const float* qrow = qp + (c / kk) * d;
  float acc = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float diff = rows[static_cast<int64_t>(crow[j / l]) * d + j] - qrow[j];
    acc = __fmaf_rn(diff, diff, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) out[c] = acc;
}

}  // namespace

extern "C" {

// out (nq·kk,) f32. Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError().
int vaq_decode_rescore(const void* codes, int64_t n_rows, int m,
                       const void* cand, int nq, int kk, const void* rows,
                       const void* qp, int d, void* out, void* stream) {
  const int64_t n_cand = static_cast<int64_t>(nq) * kk;
  const unsigned blocks = static_cast<unsigned>((n_cand + WARPS - 1) / WARPS);
  if (blocks > 0) {
    decode_rescore_kernel<<<blocks, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(codes), n_rows, m,
        static_cast<const int32_t*>(cand), n_cand, kk,
        static_cast<const float*>(rows), static_cast<const float*>(qp), d,
        d / m, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
