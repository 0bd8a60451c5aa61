// RWKV6 (Finch) chunked wkv recurrence, with an initial state in and the
// final state out:
//
//   out_t = r_t . (S_{t-1} + diag(u) k_t^T v_t)
//   S_t   = diag(w_t) S_{t-1} + k_t^T v_t,        w_t = exp(logw_t)
//
// per (batch, head), r/k/v/logw (B, S, H, K) float32, u (H, K), the state
// (B, H, K, K) float32. It computes what repro.models.rwkv6.wkv_chunked
// computes: the model's prefill runs it once per layer.
//
// Replaces: src/repro/kernels/wkv_chunk.py, wkv_chunk_pallas (the TPU
// kernel: grid (B, H, S/64) with the chunk axis sequential, the (K, K)
// state in a VMEM scratch that persists across it, a zero initial state and
// no state out, S a multiple of the chunk).
//
// Bound on this card: bytes, narrowly. Per token and head the recurrence
// reads 4 K floats and writes K (1.25 KB at K = 64) against at least
// 5 K^2 + 6 K operations (20.9k: r . S, then S <- w S + k^T v; the u bonus
// and exp(logw) are O(K)): ~16 operations per byte, under the ridge of the
// card's float32 rate over its memory rate (67 TFLOP/s / 3.35 TB/s = 20).
// At (1, 2048, 40, 64) that is 0.032 ms by bytes, 0.026 ms by operations.
//
// Design (a first, simple kernel: right before fast). One CTA of 512
// threads per (b, h) walks the sequence in chunks of 64 positions, in
// order -- the loop inside the CTA takes the place of the TPU grid's
// sequential axis -- with the (K, K) state in shared memory for the whole
// walk. Per chunk:
//   1. load the r, k, v, logw tiles (each warp reads 128-B spans);
//      positions past the end of the sequence read as zero, so any S
//      works, the tail chunk included (logw = 0 keeps the decay flat,
//      k = v = 0 add nothing);
//   2. one thread per channel sums the log-decays in position order:
//      L[t] (inclusive) and Lex[t] = L[t-1] (exclusive), so the decay
//      between neighbours is exactly exp(0);
//   3. A[t][s] = sum_c r[t][c] k[s][c] exp(min(Lex[t][c] - L[s][c], 0))
//      for s < t, the u bonus sum_c r[t][c] u[c] k[t][c] for s = t: each
//      pair of positions gets its own log-decay difference, which is <= 0,
//      clamped so rounding cannot make it positive -- exp(+L) is never
//      formed, whatever the decays (logw lies in [-4.9e8, -2e-9]);
//   4. r <- r exp(Lex) (decay from the chunk start), k <- k exp(Lend - L)
//      (decay to the chunk end);
//   5. out[t] = sum_{s<=t} A[t][s] v[s] + r[t] . S, written to memory;
//   6. S <- diag(exp(Lend)) S + sum_s k[s]^T v[s].
// Shared memory: rows of r, k, L, Lex padded to K + 1 floats (odd, so 32
// consecutive rows fall in 32 banks), 116 KB at K = 64 (above 48 KB, by
// the dynamic-shared-memory opt-in). Float32 on the CUDA cores, no tensor
// cores; explicit fmaf in the sums (the library is built with -fmad=false,
// which keeps the compiler from contracting anything else).
//
// Exactness: none. The plain version (ref.py, wkv_chunked_ref) factors the
// decays through sub-block boundaries and sums in another order, so the two
// agree to the reference's bound, max|d| / (max|ref| + 1) < 5e-4.
//
// Where it loses: B * H CTAs (40 at B = 1 on 132 SMs), one exp per (t, s,
// c) triple, broadcast shared-memory reads in the products. The next steps
// are splitting V columns or chunks across CTAs and the boundary-factored
// products on the tensor cores.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;    // positions per chunk
constexpr int kThreads = 512;

template <int K>
constexpr size_t smem_bytes() {
  return sizeof(float) * (4 * kChunk * (K + 1) + kChunk * K +
                          kChunk * (kChunk + 1) + K * K + K);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
wkv_chunk_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ lw,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ out, float* __restrict__ s1, int64_t S,
                 int64_t H) {
  constexpr int P = K + 1;        // padded row stride of r, k, L, Lex
  constexpr int PA = kChunk + 1;  // padded row stride of A
  extern __shared__ float sm[];
  float* sr = sm;                // [64][P] r, then r * exp(Lex)
  float* sk = sr + kChunk * P;   // [64][P] k, then k * exp(Lend - L)
  float* sL = sk + kChunk * P;   // [64][P] inclusive log-decay
  float* sX = sL + kChunk * P;   // [64][P] logw, then exclusive log-decay
  float* sv = sX + kChunk * P;   // [64][K] v
  float* sA = sv + kChunk * K;   // [64][PA] intra-chunk weights
  float* st = sA + kChunk * PA;  // [K][K] the state
  float* sE = st + K * K;        // [K] the chunk's total log-decay

  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.x;
  const int64_t h = bh % H;
  const int64_t step = H * K;                  // between positions
  const int64_t base = (bh / H) * S * step + h * K;  // (b, 0, h, 0)
  const float* uh = u + h * K;

  for (int e = tid; e < K * K; e += kThreads) st[e] = s0[bh * K * K + e];

  for (int64_t c0 = 0; c0 < S; c0 += kChunk) {
    const int n = (int)(S - c0 < kChunk ? S - c0 : kChunk);
    const int64_t g0 = base + c0 * step;

    // 1. the chunk's tiles
    for (int e = tid; e < kChunk * K; e += kThreads) {
      const int t = e / K, c = e % K;
      float rv = 0.f, kv = 0.f, vv = 0.f, wv = 0.f;
      if (t < n) {
        const int64_t g = g0 + t * step + c;
        rv = r[g];
        kv = k[g];
        vv = v[g];
        wv = lw[g];
      }
      sr[t * P + c] = rv;
      sk[t * P + c] = kv;
      sv[t * K + c] = vv;
      sX[t * P + c] = wv;
    }
    __syncthreads();

    // 2. log-decay prefix sums, one thread per channel
    if (tid < K) {
      float acc = 0.f;
      for (int t = 0; t < kChunk; ++t) {
        const float w = sX[t * P + tid];
        sX[t * P + tid] = acc;
        acc = __fadd_rn(acc, w);
        sL[t * P + tid] = acc;
      }
      sE[tid] = acc;
    }
    __syncthreads();

    // 3. intra-chunk weights; a warp covers 32 consecutive s of one t
    for (int e = tid; e < kChunk * kChunk; e += kThreads) {
      const int t = e / kChunk, s = e % kChunk;
      float a = 0.f;
      if (t < n && s < t) {
        const float* rt = sr + t * P;
        const float* xt = sX + t * P;
        const float* ks = sk + s * P;
        const float* ls = sL + s * P;
#pragma unroll 8
        for (int c = 0; c < K; ++c)
          a = fmaf(rt[c] * ks[c], expf(fminf(xt[c] - ls[c], 0.f)), a);
      } else if (t < n && s == t) {
        const float* rt = sr + t * P;
        const float* kt = sk + t * P;
#pragma unroll 8
        for (int c = 0; c < K; ++c) a = fmaf(rt[c] * uh[c], kt[c], a);
      }
      sA[t * PA + s] = a;
    }
    __syncthreads();

    // 4. decay r from the chunk start and k to the chunk end
    for (int e = tid; e < kChunk * K; e += kThreads) {
      const int t = e / K, c = e % K;
      sr[t * P + c] *= expf(fminf(sX[t * P + c], 0.f));
      sk[t * P + c] *= expf(fminf(sE[c] - sL[t * P + c], 0.f));
    }
    __syncthreads();

    // 5. outputs; a warp covers consecutive columns j
    for (int e = tid; e < kChunk * K; e += kThreads) {
      const int t = e / K, j = e % K;
      if (t >= n) continue;
      float o = 0.f;
      for (int s = 0; s <= t; ++s) o = fmaf(sA[t * PA + s], sv[s * K + j], o);
      const float* rt = sr + t * P;
#pragma unroll 8
      for (int c = 0; c < K; ++c) o = fmaf(rt[c], st[c * K + j], o);
      out[g0 + t * step + j] = o;
    }
    __syncthreads();

    // 6. the state, each element updated by the thread that owns it
    for (int e = tid; e < K * K; e += kThreads) {
      const int c = e / K, j = e % K;
      float acc = st[e] * expf(fminf(sE[c], 0.f));
      for (int s = 0; s < n; ++s) acc = fmaf(sk[s * P + c], sv[s * K + j], acc);
      st[e] = acc;
    }
    __syncthreads();
  }

  for (int e = tid; e < K * K; e += kThreads) s1[bh * K * K + e] = st[e];
}

template <int K>
int launch(const float* r, const float* k, const float* v, const float* lw,
           const float* u, const float* s0, float* out, float* s1, int64_t B,
           int64_t S, int64_t H, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<K>();
  cudaError_t err = cudaFuncSetAttribute(
      wkv_chunk_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  wkv_chunk_kernel<K><<<(unsigned)(B * H), kThreads, smem, stream>>>(
      r, k, v, lw, u, s0, out, s1, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, lw: (B, S, H, K) float32; u: (H, K); s0: (B, H, K, K); out:
// (B, S, H, K); s1: (B, H, K, K) (may alias s0: each CTA reads its state
// before it writes it). All contiguous, on the device. K must be 16 (the
// smoke config) or 64 (rwkv6-3b); B * H >= 1 and S >= 1.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int wkv_chunk_launch(const float* r, const float* k,
                                const float* v, const float* lw,
                                const float* u, const float* s0, float* out,
                                float* s1, int64_t B, int64_t S, int64_t H,
                                int64_t K, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 16: return launch<16>(r, k, v, lw, u, s0, out, s1, B, S, H, st);
    case 64: return launch<64>(r, k, v, lw, u, s0, out, s1, B, S, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
