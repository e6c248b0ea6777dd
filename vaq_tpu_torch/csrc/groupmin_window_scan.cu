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
// in f32, where qsl is the slot's bf16 query, already scaled by −2 (and by
// the per-dim int8 scales for int8 rows) and x the stored row, int8 or bf16.
// qn is the norm of that bf16 slab, as in the JAX kernel; the minima only
// rank windows, and must rank them as JAX does. Products of bf16 and int8
// (or bf16) values are exact in f32, so only summation order differs.
// Slots at or past n_slots[c] (when given) are empty: they read +inf, and a
// query tile with no occupied slot is not scored at all.
//
// What bounds it: 2·qcap·d operations per row. At the 1M shapes (1000
// clusters of 1536 int8 rows, d = 128, 112 slots) that is 44 GFLOP against
// 197 MB of rows, 29 MB of query slabs and 86 MB of minima. This first
// version runs the products on the f32 CUDA cores, as K1 does: a block
// takes one cluster's 64-row tile (several for groups longer than 64 rows)
// and 64 query slots, stages rows and slots in shared memory 32 columns at a
// time, 4 rows × 4 slots per thread, reduces each thread's 4 rows (one
// group, since gs ≥ 8), then the threads of a group through shared memory.
// The bf16 MMA of the tensor cores is the lever for a later version; the
// TPU kernel's VMEM slab budgets and static inner tiles have no counterpart.

#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TR = 64;        // rows per tile
constexpr int TQ = 64;        // query slots per block
constexpr int DK = 32;        // columns staged per step
constexpr int PAD = 4;        // keeps rows 16-byte aligned for float4 reads
constexpr int THREADS = 256;  // 16 × 16 threads, 4 rows × 4 slots each
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
groupmin_kernel(const __nv_bfloat16* __restrict__ qsl, const T* __restrict__ rows,
                const float* __restrict__ w, const int32_t* __restrict__ n_slots,
                int cap, int qcap, int d, int gs, int span,
                float* __restrict__ out) {
  __shared__ __align__(16) float xs[DK][TR + PAD];  // rows, transposed
  __shared__ __align__(16) float qs[DK][TQ + PAD];  // slots, transposed
  __shared__ float xn_s[TR];
  __shared__ float qn_s[TQ];
  __shared__ float part[TR / 4][TQ];  // per row quad: min over its 4 rows
  __shared__ float run[TQ];           // running min of a group > TR rows

  const int tid = threadIdx.x;
  const int spans = cap / span;
  const int c = blockIdx.x / spans;
  const int sp = blockIdx.x % spans;
  const int q0 = blockIdx.y * TQ;
  const int ng = cap / gs;
  const int live = n_slots != nullptr ? min(n_slots[c], qcap) : qcap;
  const int nq_tile = min(TQ, qcap - q0);
  const int g0 = sp * span / gs;  // first group of this span
  float* out_c = out + static_cast<int64_t>(c) * qcap * ng;

  if (q0 >= live) {  // no occupied slot in this tile: +inf, nothing scored
    const int groups = span / gs;
    for (int i = tid; i < nq_tile * groups; i += THREADS) {
      const int qq = i / groups, g = i % groups;
      out_c[static_cast<int64_t>(q0 + qq) * ng + g0 + g] = INFINITY;
    }
    return;  // uniform across the block, before any barrier
  }

  const __nv_bfloat16* qbase = qsl + (static_cast<int64_t>(c) * qcap + q0) * d;
  {
    // qn = 0.25·‖qsl‖², one warp per slot
    const int warp = tid / 32, lane = tid % 32;
    for (int qq = warp; qq < TQ; qq += WARPS) {
      float s = 0.f;
      if (qq < nq_tile)
        for (int j = lane; j < d; j += 32) {
          const float v = to_f32(qbase[static_cast<int64_t>(qq) * d + j]);
          s = __fmaf_rn(v, v, s);
        }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) qn_s[qq] = 0.25f * s;
    }
  }

  const int tr = tid / 16, tq = tid % 16;
  const int chunks = span / TR;
  const int gsub = gs < TR ? gs : TR;  // rows of one group inside a tile
  const int cgroups = TR / gsub;       // groups per tile
  const int tpg = gsub / 4;            // row quads per group inside a tile
  const int long_group = gs > TR ? gs / TR : 1;  // tiles per group
  const T* rbase = rows + (static_cast<int64_t>(c) * cap + static_cast<int64_t>(sp) * span) * d;

  for (int ch = 0; ch < chunks; ++ch) {
    const T* rch = rbase + static_cast<int64_t>(ch) * TR * d;
    float acc[4][4] = {};
    float nrm = 0.f;
    for (int d0 = 0; d0 < d; d0 += DK) {
      const int dk = min(DK, d - d0);
      for (int i = tid; i < TR * DK; i += THREADS) {
        const int r = i / DK, kk = i % DK;
        xs[kk][r] = kk < dk ? to_f32(rch[static_cast<int64_t>(r) * d + d0 + kk]) : 0.f;
      }
      for (int i = tid; i < TQ * DK; i += THREADS) {
        const int qq = i / DK, kk = i % DK;
        qs[kk][qq] = (kk < dk && qq < nq_tile)
                         ? to_f32(qbase[static_cast<int64_t>(qq) * d + d0 + kk])
                         : 0.f;
      }
      __syncthreads();
      if (tid < TR) {
        // xn: one thread per row; x² is exact in f32
        for (int kk = 0; kk < dk; ++kk) {
          const float x = xs[kk][tid];
          nrm = __fmaf_rn(x * x, __ldg(&w[d0 + kk]), nrm);
        }
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
    if (tid < TR) xn_s[tid] = nrm;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float m = INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // (dot + xn) + qn, rounded step by step as the JAX kernel adds them
        const float dist = __fadd_rn(__fadd_rn(acc[i][j], xn_s[tr * 4 + i]), qn_s[tq * 4 + j]);
        m = fminf(m, dist);
      }
      part[tr][tq * 4 + j] = m;
    }
    __syncthreads();
    for (int i = tid; i < cgroups * TQ; i += THREADS) {
      const int qq = i / cgroups, g = i % cgroups;
      float v = part[g * tpg][qq];
      for (int t = 1; t < tpg; ++t) v = fminf(v, part[g * tpg + t][qq]);
      int gi = g0 + ch * cgroups + g;
      if (long_group > 1) {
        // one group spans long_group tiles (cgroups == 1, so the same
        // thread owns run[qq] on every tile)
        v = ch % long_group == 0 ? v : fminf(run[qq], v);
        run[qq] = v;
        if (ch % long_group != long_group - 1) continue;
        gi = g0 + ch / long_group;
      }
      if (qq < nq_tile)
        out_c[static_cast<int64_t>(q0 + qq) * ng + gi] = q0 + qq < live ? v : INFINITY;
    }
    __syncthreads();
  }
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
  const int span = gs > TR ? gs : TR;
  const dim3 grid(static_cast<unsigned>(static_cast<int64_t>(ncl) * (cap / span)),
                  static_cast<unsigned>((qcap + TQ - 1) / TQ));
  const auto st = static_cast<cudaStream_t>(stream);
  const auto q = static_cast<const __nv_bfloat16*>(qsl);
  const auto wf = static_cast<const float*>(w);
  const auto ns = static_cast<const int32_t*>(n_slots);
  const auto o = static_cast<float*>(out);
  if (grid.x > 0 && grid.y > 0) {
    if (rows_int8)
      groupmin_kernel<int8_t><<<grid, THREADS, 0, st>>>(
          q, static_cast<const int8_t*>(rows), wf, ns, cap, qcap, d, gs, span, o);
    else
      groupmin_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
          q, static_cast<const __nv_bfloat16*>(rows), wf, ns, cap, qcap, d, gs, span, o);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
