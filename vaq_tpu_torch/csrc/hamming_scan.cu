// H1 — popcount distances between packed bit-vectors, the binary engine's
// scan.
//
// JAX has no Pallas kernel for it: it writes the XOR (or AND/OR) +
// jax.lax.population_count + word sum inline in XLA, in the flat Hamming
// scan (vaq_tpu/binary.py:121-122), the progressive filters (:352-353,
// :401-402), the cluster probe's block scoring (:738-739) and the Jaccard
// distance (vaq_tpu/ops/distances.py:86-91). This one kernel serves all of
// them: for B batches of (query tile, row tile) it returns, over the words
// [lo, lo + w) of each row,
//     xor:      Σ popc(q ^ x)                               int32
//     jaccard:  inter = Σ popc(q & x), union = pop(q) + pop(x) − inter,
//               union == 0 ? 0 : 1 − inter / max(union, 1)   f32
// The Jaccard union equals JAX's Σ popc(q | x) exactly (integers), and the
// f32 expression is JAX's in the same order, with IEEE division and
// subtraction, so the values are bit-equal.
//
// What bounds it: one popc per (query, row, word). Hopper retires 16 popc a
// clock per SM (the CUDA C++ Programming Guide's throughput table, compute
// capability 9.0), against 64 or more for the XOR and the add beside it, so
// the popcounts bound it: 512 queries × 1M rows × 8 words is 4.2e9 popc,
// about 1 ms on 132 SMs at 1.98 GHz, above the 2 GB of int32 output (0.6 ms
// at 3.35 TB/s). The design keeps everything else out of their way:
//
// - a block of 128 threads owns 128 consecutive rows (one a thread) and a
//   tile of 32 queries, whose words it stages once in shared memory,
//   zero-padded to whole chunks of 8 words (XOR, AND of zero words add 0);
// - a thread holds 8 of its row's words in registers at a time and the 32
//   queries' running sums, so each staged query word, read as a broadcast
//   16-byte load, feeds every thread of the warp;
// - each query's results go out as one coalesced 128-row store.
//
// A simple kernel: popcounts of several words are not merged (Harley-Seal)
// and the binary tensor-core product (mma .b1) is not used; those are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 128;   // rows a block, one a thread
constexpr int QT = 32;      // queries a block
constexpr int CHUNK = 8;    // row words in registers at once
constexpr int SMEM_LIMIT = 232448;

template <bool JACCARD>
__global__ void __launch_bounds__(ROWS)
popcount_dists_kernel(const uint32_t* __restrict__ q,
                      const uint32_t* __restrict__ x, int nq, int64_t n,
                      int ld, int lo, int w, int wpad, void* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t qs[];  // [QT][wpad], then [QT] pops
  int* qpop = reinterpret_cast<int*>(qs + QT * wpad);
  const int64_t b = blockIdx.z;
  const int q0 = blockIdx.y * QT;
  const int nqt = min(QT, nq - q0);
  const uint32_t* qb = q + (b * nq + q0) * static_cast<int64_t>(ld) + lo;
  for (int i = threadIdx.x; i < QT * wpad; i += ROWS) {
    const int qi = i / wpad, j = i - qi * wpad;
    qs[i] = (qi < nqt && j < w) ? __ldg(qb + static_cast<int64_t>(qi) * ld + j) : 0u;
  }
  __syncthreads();
  if (JACCARD) {
    for (int qi = threadIdx.x; qi < QT; qi += ROWS) {
      int s = 0;
      for (int j = 0; j < wpad; ++j) s += __popc(qs[qi * wpad + j]);
      qpop[qi] = s;
    }
    __syncthreads();
  }

  const int64_t row = static_cast<int64_t>(blockIdx.x) * ROWS + threadIdx.x;
  const bool live = row < n;
  const uint32_t* xr = x + (b * n + (live ? row : 0)) * ld + lo;
  int acc[QT];
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) acc[qi] = 0;
  int xpop = 0;
  for (int c = 0; c < wpad; c += CHUNK) {
    uint32_t xw[CHUNK];
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) xw[j] = (live && c + j < w) ? __ldg(xr + c + j) : 0u;
    if (JACCARD) {
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) xpop += __popc(xw[j]);
    }
#pragma unroll
    for (int qi = 0; qi < QT; ++qi) {
      const uint4* qv = reinterpret_cast<const uint4*>(qs + qi * wpad + c);
      const uint4 a = qv[0], e = qv[1];
      const uint32_t qw[CHUNK] = {a.x, a.y, a.z, a.w, e.x, e.y, e.z, e.w};
      int s = 0;
#pragma unroll
      for (int j = 0; j < CHUNK; ++j) s += __popc(JACCARD ? (qw[j] & xw[j]) : (qw[j] ^ xw[j]));
      acc[qi] += s;
    }
  }
  if (!live) return;
  const int64_t o = (b * nq + q0) * n + row;
#pragma unroll
  for (int qi = 0; qi < QT; ++qi) {
    if (qi >= nqt) break;
    if (JACCARD) {
      const int inter = acc[qi];
      const int uni = qpop[qi] + xpop - inter;
      const float frac = __fdiv_rn(static_cast<float>(inter), fmaxf(static_cast<float>(uni), 1.0f));
      static_cast<float*>(out)[o + qi * n] = uni == 0 ? 0.0f : __fsub_rn(1.0f, frac);
    } else {
      static_cast<int*>(out)[o + qi * n] = acc[qi];
    }
  }
}

}  // namespace

extern "C" {

// q (b, nq, ld) and x (b, n, ld) uint32 words, row-major; the words
// [lo, lo + w) of each row are compared. out (b, nq, n): int32 for xor
// (jaccard = 0), f32 for jaccard (jaccard = 1). Returns the launch's CUDA
// error (0 when none).
int vaq_popcount_dists(const void* q, const void* x, int b, int nq, int64_t n,
                       int ld, int lo, int w, int jaccard, void* out,
                       void* stream) {
  if (b == 0 || nq == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  const int wpad = (w + CHUNK - 1) / CHUNK * CHUNK;
  const int smem = (QT * wpad + QT) * 4;
  const int64_t row_tiles = (n + ROWS - 1) / ROWS;
  const int q_tiles = (nq + QT - 1) / QT;
  if (w < 1 || smem > SMEM_LIMIT || row_tiles > INT32_MAX || q_tiles > 65535 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = jaccard ? popcount_dists_kernel<true> : popcount_dists_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(row_tiles), q_tiles, b);
  kernel<<<grid, ROWS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(x), nq, n, ld, lo, w,
      wpad, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
