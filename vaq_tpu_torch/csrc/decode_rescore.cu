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
// C × d f32 table, 128 KB at C = 256, stays in L1/L2), ~100k candidates per
// batch — a few MB, about 1.3 µs at 3.35 TB/s. What the time is made of is
// latency: each candidate is a chain of three dependent loads (its id, its
// code bytes, the table values they pick). So a warp takes a batch of B
// candidates of one query and issues each stage for the whole batch before
// the next, and before any arithmetic:
//
// 1. the batch's ids, one coalesced load (lane b holds candidate b's);
// 2. for each candidate and each of the lane's column units, the code byte
//    of the unit's subspace;
// 3. the table values those codes pick, through the read-only path.
//
// A lane owns fixed units of U columns, units lane, lane + 32, … (UPL of
// them), so its q values load once for all its batches. U = 4 where a
// unit's four columns lie in one subspace (L % 4 == 0, as at the main
// shape, M = 32, L = 4) and the table and the queries are 16-byte aligned:
// one code byte and one 16-byte table load a unit. Otherwise U = 1, any
// d = M·L (d = 30 as well as 512). A d wider than 32·U·UPL goes in column
// passes that reload q. B is set so a batch's codes and values take about
// 64 registers. The batch's B sums reduce over the warp by a
// reduce-scatter (B − 1 + log2(32 / B) shuffles, not 5·B), which leaves
// candidate b's sum in lanes b·32/B …, and they store it: one coalesced
// store a batch. (Holding only the code bytes of 32 candidates in flight
// and reading the table eight candidates at a time was slower: 0.0177
// against 0.0157 ms at the main shape, NVIDIA H100 80GB HBM3, 700 W.)

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;  // a block: one query, up to WARPS·B candidates a round
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

// Candidates a warp batch: a power of two in [2, 16], about 64 registers of
// codes and values (UPL·(U + 1) a candidate).
__host__ __device__ constexpr int batch(int u, int upl) {
  int b = 16;
  while (b > 2 && b * upl * (u + 1) > 64) b /= 2;
  return b;
}

// v[b] summed over the warp: afterwards lane l holds candidate
// l / (32 / B)'s sum. Each halving step keeps half of the values and adds
// the partner lane's copy of them, so B values cost B − 1 shuffles.
template <int B>
__device__ __forceinline__ float reduce_scatter(float (&v)[B], int lane) {
#pragma unroll
  for (int h = B / 2, off = 16; h >= 1; h /= 2, off /= 2) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = upper ? v[i] : v[i + h];
      const float keep = upper ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, off);
    }
  }
  float a = v[0];
#pragma unroll
  for (int off = 16 / B; off > 0; off /= 2) a += __shfl_xor_sync(FULL, a, off);
  return a;
}

template <int U>
__device__ __forceinline__ void load_unit(const float* p, float (&v)[U]) {
  if constexpr (U == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

template <int U, int UPL>
__global__ void __launch_bounds__(THREADS)
decode_rescore_kernel(const uint8_t* __restrict__ codes, int64_t n_rows, int m,
                      const int32_t* __restrict__ cand, int kk,
                      const float* __restrict__ rows, const float* __restrict__ qp,
                      int d, int l, float* __restrict__ out) {
  constexpr int B = batch(U, UPL);
  const int qi = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* qrow = qp + static_cast<int64_t>(qi) * d;
  const int32_t* crow = cand + static_cast<int64_t>(qi) * kk;
  const int units = d / U;
  const int passes = (units + 32 * UPL - 1) / (32 * UPL);
  float q[UPL][U];
  int sub[UPL];  // the subspace of each of the lane's units
  auto load_q = [&](int u0) {
#pragma unroll
    for (int i = 0; i < UPL; ++i) {
      const int u = u0 + lane + 32 * i;
      if (u < units) {
        load_unit<U>(qrow + U * u, q[i]);
      } else {
#pragma unroll
        for (int e = 0; e < U; ++e) q[i][e] = 0.f;
      }
      sub[i] = u < units ? U * u / l : 0;
    }
  };
  load_q(0);
  for (int b0 = (blockIdx.y * WARPS + warp) * B; b0 < kk; b0 += gridDim.y * WARPS * B) {
    // stage 1: the batch's ids
    int32_t id = -1;
    if (lane < B && b0 + lane < kk) id = __ldg(crow + b0 + lane);
    const bool ok_l = id >= 0 && id < n_rows;
    float acc[B];
#pragma unroll
    for (int b = 0; b < B; ++b) acc[b] = 0.f;
    for (int p = 0; p < passes; ++p) {
      const int u0 = p * 32 * UPL;
      if (p > 0) load_q(u0);
      // stage 2: the code byte of each unit's subspace, every candidate
      uint32_t code[B][UPL];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        const int32_t idb = __shfl_sync(FULL, id, b);
        const bool okb = __shfl_sync(FULL, ok_l, b);
        const uint8_t* cr = codes + static_cast<int64_t>(okb ? idb : 0) * m;
#pragma unroll
        for (int i = 0; i < UPL; ++i)
          code[b][i] = okb && u0 + lane + 32 * i < units ? __ldg(cr + sub[i]) : 0u;
      }
      // stage 3: the table values they pick
      float x[B][UPL][U];
#pragma unroll
      for (int b = 0; b < B; ++b)
#pragma unroll
        for (int i = 0; i < UPL; ++i) {
          const int u = u0 + lane + 32 * i;
          if (u < units) {
            load_unit<U>(rows + static_cast<int64_t>(code[b][i]) * d + U * u, x[b][i]);
          } else {
#pragma unroll
            for (int e = 0; e < U; ++e) x[b][i][e] = 0.f;
          }
        }
#pragma unroll
      for (int b = 0; b < B; ++b)
#pragma unroll
        for (int i = 0; i < UPL; ++i)
#pragma unroll
          for (int e = 0; e < U; ++e) {
            const float diff = x[b][i][e] - q[i][e];
            acc[b] = __fmaf_rn(diff, diff, acc[b]);
          }
    }
    if (passes > 1) load_q(0);
    const float sum = reduce_scatter<B>(acc, lane);
    const int b = lane / (32 / B);
    const bool ok = __shfl_sync(FULL, ok_l, b);
    if (lane % (32 / B) == 0 && b0 + b < kk)
      out[static_cast<int64_t>(qi) * kk + b0 + b] = ok ? sum : INFINITY;
  }
}

template <int U, int UPL>
void launch(const void* codes, int64_t n_rows, int m, const void* cand, int nq, int kk,
            const void* rows, const void* qp, int d, void* out, cudaStream_t st) {
  const int per_block = WARPS * batch(U, UPL);
  const dim3 grid(static_cast<unsigned>(nq),
                  static_cast<unsigned>((kk + per_block - 1) / per_block));
  decode_rescore_kernel<U, UPL><<<grid, THREADS, 0, st>>>(
      static_cast<const uint8_t*>(codes), n_rows, m, static_cast<const int32_t*>(cand), kk,
      static_cast<const float*>(rows), static_cast<const float*>(qp), d, d / m,
      static_cast<float*>(out));
}

}  // namespace

extern "C" {

// out (nq·kk,) f32. Launches on `stream`, allocates nothing, does not
// synchronise; returns cudaGetLastError().
int vaq_decode_rescore(const void* codes, int64_t n_rows, int m,
                       const void* cand, int nq, int kk, const void* rows,
                       const void* qp, int d, void* out, void* stream) {
  if (static_cast<int64_t>(nq) * kk > 0) {
    const auto st = static_cast<cudaStream_t>(stream);
    const bool quads = (d / m) % 4 == 0 && (reinterpret_cast<uintptr_t>(rows) & 15) == 0 &&
                       (reinterpret_cast<uintptr_t>(qp) & 15) == 0;
    const int per_lane = (d + 32 - 1) / 32;  // columns a lane
    if (quads) {
      if (per_lane <= 4)
        launch<4, 1>(codes, n_rows, m, cand, nq, kk, rows, qp, d, out, st);
      else if (per_lane <= 8)
        launch<4, 2>(codes, n_rows, m, cand, nq, kk, rows, qp, d, out, st);
      else
        launch<4, 4>(codes, n_rows, m, cand, nq, kk, rows, qp, d, out, st);
    } else if (per_lane <= 1) {
      launch<1, 1>(codes, n_rows, m, cand, nq, kk, rows, qp, d, out, st);
    } else if (per_lane <= 2) {
      launch<1, 2>(codes, n_rows, m, cand, nq, kk, rows, qp, d, out, st);
    } else if (per_lane <= 4) {
      launch<1, 4>(codes, n_rows, m, cand, nq, kk, rows, qp, d, out, st);
    } else if (per_lane <= 8) {
      launch<1, 8>(codes, n_rows, m, cand, nq, kk, rows, qp, d, out, st);
    } else {
      launch<1, 16>(codes, n_rows, m, cand, nq, kk, rows, qp, d, out, st);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
