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
// 5 K^2 + 6 K operations: ~16 operations per byte, under the ridge of the
// card's float32 rate over its memory rate (67 TFLOP/s / 3.35 TB/s = 20).
// At (1, 2048, 40, 64) that is 0.032 ms by bytes, 0.026 ms by operations.
//
// Design: chunk-parallel, with only the (K, K) state recurrence in chunk
// order. Cut each (b, h) sequence into nc = ceil(S / 64) chunks; per chunk
// c let L be the inclusive log-decay prefix sum, Lex[t] = L[t-1] (0 at
// t = 0) the exclusive one, read from the same array so that neighbours
// decay by exactly exp(0), and Lend = L[63]. Then
//
//   out_c = A_c v_c + (r ⊙ exp(Lex)) S_{c-1}
//   S_c   = diag(exp(Lend_c)) S_{c-1} + dS_c,  dS_c = (k ⊙ exp(Lend - L))^T v
//
// where A_c (64 x 64, lower-triangular) and dS_c depend on chunk c alone.
// One call launches three kernels on the caller's stream:
//   1. wkv_pass1_state, B*H*nc CTAs of 128 threads (1280 at (1, 2048, 40,
//      64)): the chunk's k, v, logw tiles by cp.async, L, then dS_c
//      (warp w: state rows 16w..16w+15) and exp(Lend_c) to the scratch;
//   2. wkv_pass2_scan, one thread per state element (B*H*K*K = 163,840):
//      walks the chunks in order, S_{c-1} to the scratch and the final
//      state out -- the only step in chunk order, elementwise, each
//      chunk's dS and decay loaded independently of the running state;
//   3. wkv_pass3_out, B*H*nc CTAs of 256 threads, two warps per 16-row
//      sub-block j:
//      - its diagonal 16 x 16 block of A, each pair's own decay
//        exp(Lex_t - L_s) and the u bonus on the CUDA cores (the only
//        per-pair exponentials): a lane keeps rows p and 15 - p of r and
//        Lex for 8 of the channels in registers and walks s, and the 8
//        lanes' partial sums of an entry are added across lanes;
//      - its cross blocks i < j, factored through the sub-block's start
//        Lb = L[16j - 1] as in the reference (src/repro/kernels/
//        wkv_chunk.py:54-84): r exp(Lex - Lb) times k exp(Lb - L);
//      - then (r ⊙ exp(Lex)) S_{c-1} and A v for half the output columns
//        each, in one set of registers, written out once.
// The log-decay prefix sums in passes 1 and 3 run in THREADS / K
// segments of rows per channel, each in position order. Every decay is
// exp(min(x, 0)), so nothing overflows whatever the log-decays (ROADMAP
// F9). Positions past S load as r = k = v = 0 and logw = 0 (cp.async's
// zero fill): a tail chunk neither decays the state nor adds to it, so any
// S >= 1 runs with no fallback.
//
// The four products per chunk and head -- the cross blocks of r~ k~^T,
// A v, r~ S, k~^T v -- run on the tensor cores (mma.sync m16n8k8 .tf32)
// in 3xTF32: each operand is split a = hi + lo, hi = tf32(a), lo =
// tf32(a - hi), and a b ~ hi hi' + hi lo' + lo hi', the small terms first.
// Plain TF32 keeps 10 mantissa bits (relative error 2^-11 ~ 4.9e-4), the
// size of the port's stated bound itself (ROADMAP F7); the split keeps
// about 2^-22, float32's order, at a third of the TF32 rate -- still far
// above the CUDA cores' float32 rate, and not what sets this kernel's time.
//
// Scratch (the caller's, allocated by the wrapper): dS and S_{c-1} for
// every chunk and exp(Lend_c), B*H*nc*K*(2K+1) floats (42.3 MB at
// (1, 2048, 40, 64)), written and read back within the call.
//
// Shared memory rows are padded so the mma fragment reads hit 32 banks:
// rows read as (row = lane/4, col = lane%4) fragments by K + 4 floats,
// rows read as (row = lane%4, col = lane/4) by K + 8. Pass 3 holds r, k,
// L, v, S_{c-1} and A: 104 KB at K = 64 (two CTAs an SM); pass 1 54 KB.
// Float sums outside the products use explicit fmaf; the library is built
// with -fmad=false, which keeps the compiler from contracting anything
// else.
//
// Exactness: none. The plain version (ref.py, wkv_chunked_ref) factors all
// decays through sub-block boundaries of chunks of its own length and sums
// in another order, so the two agree to the reference's bound,
// max|d| / (max|ref| + 1) < 5e-4. ref.py's wkv_chunk_passes_ref mirrors
// these three passes in plain torch.
//
// Where it still loses: the passes move ~250 MB at (1, 2048, 40, 64) --
// k, v and logw are read twice, dS and S_{c-1} go through the scratch --
// against the 106 MB the function must move (0.075 ms at the card's
// memory rate, against a 0.032 ms bound), and pass 3's arithmetic (30.7k
// per-pair exponentials a chunk and head, the 3xTF32 splits) overlaps its
// loads only across its two CTAs an SM. A single pass that hands each
// chunk's state to the next CTA (decoupled look-back) would read every
// input once.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;            // positions per chunk
constexpr int kSub = 16;              // positions per sub-block
constexpr int kSubs = kChunk / kSub;  // sub-blocks per chunk
constexpr int kThreads1 = 128;        // pass 1: 4 warps
constexpr int kThreads3 = 256;        // pass 3: 2 warps per sub-block
constexpr int kScanThreads = 256;

// exp(min(x, 0)): every decay is the exponential of a log-difference
// clamped <= 0, so nothing overflows whatever the log-decays. __expf
// (ex2.approx of x log2 e): ~2 ulp, plus |x| 2^-24 from the scaling of x,
// so below 1e-6 relative wherever the result is not negligible (|x| < 20).
__device__ __forceinline__ float decay(float x) {
  return __expf(fminf(x, 0.f));
}

// ---- tensor-core helpers -------------------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// x = hi + lo, each a tf32 value: hi holds x's leading 11 significant
// bits, lo (x - hi is exact in float32) the next 11.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// 16 x 8 operand: a0 (g, q), a1 (g+8, q), a2 (g, q+4), a3 (g+8, q+4),
// g = lane / 4, q = lane % 4
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
};

struct FragB {  // 8 x 8 operand: b0 (k = q, n = g), b1 (k = q+4, n = g)
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split(b0, hi[0], lo[0]);
    split(b1, hi[1], lo[1]);
  }
};

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d (16 x 8: d0 (g, 2q), d1 (g, 2q+1), d2 (g+8, 2q), d3 (g+8, 2q+1)) += a b
// in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// ---- tiles ---------------------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// a (ROWS, K) tile (row t at src + g0 + t * step) into dst (row stride
// P); rows at or past n read as zeros (their source address stays in
// bounds)
template <int K, int P, int THREADS, int ROWS = kChunk>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t g0, int64_t step, int n) {
  constexpr int V = K / 4;
  for (int e = threadIdx.x; e < ROWS * V; e += THREADS) {
    const int t = e / V, c = 4 * (e % V);
    const bool ok = t < n;
    cp_async16(dst + t * P + c, src + g0 + (ok ? t : 0) * step + c, ok);
  }
}

// logw -> the inclusive prefix sum L, in place: THREADS / K segments of
// rows per channel, each summed in position order by one thread, then
// offset by the sum of the segments' totals before it (itself summed in
// order, so each segment's offset is bit for bit the L of the row before)
template <int K, int P, int THREADS>
__device__ __forceinline__ void prefix_sum(float* sL) {
  constexpr int R = kChunk / (THREADS / K);  // rows per segment
  const int c = threadIdx.x % K, seg = threadIdx.x / K;
  float* col = sL + seg * R * P + c;
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < R; ++t) {
    acc = __fadd_rn(acc, col[t * P]);
    col[t * P] = acc;
  }
  __syncthreads();
  float off = 0.f;
  for (int s = 0; s < seg; ++s)
    off = __fadd_rn(off, sL[((s + 1) * R - 1) * P + c]);
  __syncthreads();
  if (seg) {
#pragma unroll
    for (int t = 0; t < R; ++t) col[t * P] = __fadd_rn(off, col[t * P]);
  }
}

struct Chunk {  // where a CTA's chunk lies in the (B, S, H, K) tensors
  int64_t blk, g0, step;
  int n;
  template <int K>
  __device__ __forceinline__ static Chunk of(int64_t S, int64_t H, int nc) {
    Chunk ch;
    ch.blk = blockIdx.x;  // (b * H + h) * nc + c
    const int64_t bh = ch.blk / nc, c = ch.blk % nc;
    ch.step = H * K;
    ch.g0 = ((bh / H) * S + c * kChunk) * ch.step + (bh % H) * K;
    ch.n = (int)(S - c * kChunk < kChunk ? S - c * kChunk : kChunk);
    return ch;
  }
};

// ---- pass 1: the chunk's state increment and decay -----------------------

template <int K>
constexpr size_t pass1_smem() {
  return sizeof(float) * 3 * kChunk * (K + 8);
}

template <int K>
__global__ void __launch_bounds__(kThreads1)
wkv_pass1_state(const float* __restrict__ k, const float* __restrict__ v,
                const float* __restrict__ lw, float* __restrict__ dS,
                float* __restrict__ dec, int64_t S, int64_t H, int nc) {
  constexpr int P = K + 8;  // every tile is read k-major (row = lane % 4)
  extern __shared__ __align__(16) float sm[];
  float* sk = sm;
  float* sv = sk + kChunk * P;
  float* sL = sv + kChunk * P;
  const Chunk ch = Chunk::of<K>(S, H, nc);
  load_tile<K, P, kThreads1>(sk, k, ch.g0, ch.step, ch.n);
  load_tile<K, P, kThreads1>(sv, v, ch.g0, ch.step, ch.n);
  load_tile<K, P, kThreads1>(sL, lw, ch.g0, ch.step, ch.n);
  cp_async_wait_all();
  __syncthreads();
  prefix_sum<K, P, kThreads1>(sL);
  __syncthreads();

  const float* Lend = sL + (kChunk - 1) * P;
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  float* o = dS + ch.blk * K * K;
  // dS[c][j] = sum_s k~[s][c] v[s][j]: warp w takes state rows 16w..16w+15
  for (int m = threadIdx.x >> 5; m < K / 16; m += kThreads1 / 32) {
    const int c0 = 16 * m + g;
    const float e0 = Lend[c0], e1 = Lend[c0 + 8];
    auto kdec = [&](int s, int c, float e) {
      return sk[s * P + c] * decay(e - sL[s * P + c]);
    };
    float acc[K / 8][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < kChunk / 8; ++kk) {
      const int s = 8 * kk + q;
      FragA a;
      a.set(kdec(s, c0, e0), kdec(s, c0 + 8, e1), kdec(s + 4, c0, e0),
            kdec(s + 4, c0 + 8, e1));
#pragma unroll
      for (int nt = 0; nt < K / 8; ++nt) {
        FragB b;
        b.set(sv[s * P + 8 * nt + g], sv[(s + 4) * P + 8 * nt + g]);
        mma3(acc[nt], a, b);
      }
    }
#pragma unroll
    for (int nt = 0; nt < K / 8; ++nt) {
      const int j = 8 * nt + 2 * q;
      *reinterpret_cast<float2*>(o + c0 * K + j) =
          make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(o + (c0 + 8) * K + j) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  }
  if (threadIdx.x < K)
    dec[ch.blk * K + threadIdx.x] = decay(Lend[threadIdx.x]);
}

// ---- pass 2: the state scan, the only step in chunk order ----------------

// s0 and s1 may alias: each thread reads its element of s0 before it
// writes that element of s1.
template <int K>
__global__ void __launch_bounds__(kScanThreads)
wkv_pass2_scan(const float* s0, const float* __restrict__ dS,
               const float* __restrict__ dec, float* __restrict__ s_in,
               float* s1, int64_t BH, int nc) {
  const int64_t e = (int64_t)blockIdx.x * kScanThreads + threadIdx.x;
  if (e >= BH * K * K) return;
  const int64_t bh = e / (K * K);
  const int x = (int)(e % (K * K));
  const float* d = dS + bh * nc * K * K + x;
  const float* w = dec + bh * nc * K + x / K;
  float* o = s_in + bh * nc * K * K + x;
  float s = s0[e];
#pragma unroll 8
  for (int c = 0; c < nc; ++c) {
    o[(int64_t)c * K * K] = s;
    s = fmaf(w[(int64_t)c * K], s, d[(int64_t)c * K * K]);
  }
  s1[e] = s;
}

// ---- pass 3: the chunk's outputs -----------------------------------------

// one lane's share (C channels) of entry (t, s) of a diagonal block of A:
// sum_c r_t k_s exp(Lex_t - L_s) below the diagonal, sum_c r_t u k_t on it,
// 0 above it
template <int C>
__device__ __forceinline__ float diag_entry(
    const float (&rt)[C], const float (&xt)[C], const float (&ks)[C],
    const float (&ls)[C], const float (&uu)[C], int s, int t) {
  float a = 0.f;
  if (s < t) {
#pragma unroll
    for (int i = 0; i < C; ++i) a = fmaf(rt[i] * ks[i], decay(xt[i] - ls[i]), a);
  } else if (s == t) {
#pragma unroll
    for (int i = 0; i < C; ++i) a = fmaf(rt[i] * uu[i], ks[i], a);
  }
  return a;
}

template <int K>
constexpr size_t pass3_smem() {
  return sizeof(float) * (3 * kChunk * (K + 4) + kChunk * (K + 8) +
                          K * (K + 8) + kChunk * (kChunk + 4) + K);
}

template <int K>
__global__ void __launch_bounds__(kThreads3, 2)
wkv_pass3_out(const float* __restrict__ r, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ lw,
              const float* __restrict__ u, const float* __restrict__ s_in,
              float* __restrict__ out, int64_t S, int64_t H, int nc) {
  constexpr int PA = K + 4;        // r, k, L: read row = lane / 4
  constexpr int PB = K + 8;        // v, S: read row = lane % 4
  constexpr int PQ = kChunk + 4;   // A: read row = lane / 4
  constexpr int NT = K / 16;       // 8-column output tiles per warp
  extern __shared__ __align__(16) float sm[];
  float* sr = sm;
  float* sk = sr + kChunk * PA;
  float* sL = sk + kChunk * PA;
  float* sv = sL + kChunk * PA;
  float* sS = sv + kChunk * PB;
  float* sA = sS + K * PB;
  float* su = sA + kChunk * PQ;
  const Chunk ch = Chunk::of<K>(S, H, nc);
  load_tile<K, PA, kThreads3>(sr, r, ch.g0, ch.step, ch.n);
  load_tile<K, PA, kThreads3>(sk, k, ch.g0, ch.step, ch.n);
  load_tile<K, PA, kThreads3>(sL, lw, ch.g0, ch.step, ch.n);
  load_tile<K, PB, kThreads3>(sv, v, ch.g0, ch.step, ch.n);
  load_tile<K, PB, kThreads3, K>(sS, s_in + ch.blk * K * K, 0, K, K);
  if (threadIdx.x < K)
    su[threadIdx.x] = u[(ch.blk / nc) % H * K + threadIdx.x];
  cp_async_wait_all();
  __syncthreads();
  prefix_sum<K, PA, kThreads3>(sL);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j = warp >> 1, side = warp & 1;  // sub-block, side of its work
  const int g = lane >> 2, q = lane & 3;
  const int t0 = kSub * j;                   // the sub-block's first row
  const int ta = t0 + g, tb = ta + 8;        // this lane's fragment rows
  // the exclusive prefix of row t: L[t - 1], 0 at t = 0
  auto lex = [&](int t, int c) { return t ? sL[(t - 1) * PA + c] : 0.f; };

  // 1. the diagonal block of A. Lane (row pair p, channel group cg) of the
  //    sub-block's two warps keeps rows p and 15 - p of r and Lex, at
  //    channels cg, cg + 8, ..., in registers and walks s over the block:
  //    each pair s < t has its own decay exp(Lex_t - L_s), s = t takes the
  //    u bonus, s > t stays 0. The 8 channel groups' sums of each entry
  //    are then added across lanes.
  {
    constexpr int C = K / 8;  // channels per lane
    const int p = 4 * side + (lane >> 3), cg = lane & 7;
    const int t1 = t0 + p, t2 = t0 + kSub - 1 - p;
    float r1[C], x1[C], r2[C], x2[C], uu[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int c = cg + 8 * i;
      r1[i] = sr[t1 * PA + c];
      x1[i] = lex(t1, c);
      r2[i] = sr[t2 * PA + c];
      x2[i] = lex(t2, c);
      uu[i] = su[c];
    }
    float a[2 * kSub];  // row t1 at s = t0 + sl: a[sl]; row t2: a[16 + sl]
#pragma unroll
    for (int sl = 0; sl < kSub; ++sl) {
      float kv[C], lv[C];
#pragma unroll
      for (int i = 0; i < C; ++i) {
        kv[i] = sk[(t0 + sl) * PA + cg + 8 * i];
        lv[i] = sL[(t0 + sl) * PA + cg + 8 * i];
      }
      a[sl] = diag_entry(r1, x1, kv, lv, uu, sl, p);
      a[kSub + sl] = diag_entry(r2, x2, kv, lv, uu, sl, kSub - 1 - p);
    }
    // four sets of 8 sums, each added over the 8 lanes of a row pair: at
    // each step a lane keeps half its sums and adds its partner's half of
    // them, so lane cg ends with entry cg of each set
#pragma unroll
    for (int set = 0; set < 4; ++set) {
      float* w = a + 8 * set;
#pragma unroll
      for (int m = 4; m >= 1; m >>= 1) {
        const bool upper = cg & m;
#pragma unroll
        for (int i = 0; i < m; ++i) {
          const float send = upper ? w[i] : w[i + m];
          const float keep = upper ? w[i + m] : w[i];
          w[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
        }
      }
      sA[(set < 2 ? t1 : t2) * PQ + t0 + 8 * (set & 1) + cg] = w[0];
    }
  }

  // 2. the cross blocks (j, i < j), factored through Lb = Lex[t0]:
  //    A[t][s] = sum_c r[t][c] e^(Lex[t][c] - Lb[c]) k[s][c] e^(Lb[c] - L[s][c]);
  //    this warp takes columns 8 side .. 8 side + 7 of each block
  if (j > 0) {
    const float* Lb = sL + (t0 - 1) * PA;
    float cacc[kSubs - 1][4] = {};
#pragma unroll 2
    for (int kk = 0; kk < K / 8; ++kk) {
      const int c = 8 * kk + q;
      auto r2 = [&](int t, int cc) {
        return sr[t * PA + cc] * decay(lex(t, cc) - Lb[cc]);
      };
      auto k2 = [&](int s, int cc) {
        return sk[s * PA + cc] * decay(Lb[cc] - sL[s * PA + cc]);
      };
      FragA a;
      a.set(r2(ta, c), r2(tb, c), r2(ta, c + 4), r2(tb, c + 4));
#pragma unroll
      for (int i = 0; i < kSubs - 1; ++i) {
        if (i >= j) break;
        const int s = kSub * i + 8 * side + g;
        FragB b;
        b.set(k2(s, c), k2(s, c + 4));
        mma3(cacc[i], a, b);
      }
    }
#pragma unroll
    for (int i = 0; i < kSubs - 1; ++i) {
      if (i >= j) break;
      const int s = kSub * i + 8 * side + 2 * q;
      sA[ta * PQ + s] = cacc[i][0];
      sA[ta * PQ + s + 1] = cacc[i][1];
      sA[tb * PQ + s] = cacc[i][2];
      sA[tb * PQ + s + 1] = cacc[i][3];
    }
  }

  // 3. the carried state, for this warp's output columns
  //    8 NT side .. 8 NT (side + 1) - 1: acc = (r ⊙ exp(Lex)) S_{c-1}
  float acc[NT][4] = {};
#pragma unroll 2
  for (int kk = 0; kk < K / 8; ++kk) {
    const int c = 8 * kk + q;
    auto rdec = [&](int t, int cc) { return sr[t * PA + cc] * decay(lex(t, cc)); };
    FragA a;
    a.set(rdec(ta, c), rdec(tb, c), rdec(ta, c + 4), rdec(tb, c + 4));
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = 8 * (NT * side + n) + g;
      FragB b;
      b.set(sS[c * PB + col], sS[(c + 4) * PB + col]);
      mma3(acc[n], a, b);
    }
  }
  __syncthreads();  // every row of A is complete

  // 4. the intra-chunk terms: acc += A[t0.., 0..t0+15] v
  for (int i = 0; i <= j; ++i) {
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int s = kSub * i + 8 * kk + q;
      FragA a;
      a.set(sA[ta * PQ + s], sA[tb * PQ + s], sA[ta * PQ + s + 4],
            sA[tb * PQ + s + 4]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = 8 * (NT * side + n) + g;
        FragB b;
        b.set(sv[s * PB + col], sv[(s + 4) * PB + col]);
        mma3(acc[n], a, b);
      }
    }
  }

  // 5. the outputs of the rows inside the sequence
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = 8 * (NT * side + n) + 2 * q;
    if (ta < ch.n)
      *reinterpret_cast<float2*>(out + ch.g0 + ta * ch.step + c) =
          make_float2(acc[n][0], acc[n][1]);
    if (tb < ch.n)
      *reinterpret_cast<float2*>(out + ch.g0 + tb * ch.step + c) =
          make_float2(acc[n][2], acc[n][3]);
  }
}

// the dynamic shared memory above 48 KB, set once per device
template <int K>
cudaError_t configure() {
  static unsigned long long done = 0;  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (done >> (dev & 63) & 1)) return err;
  err = cudaFuncSetAttribute(wkv_pass1_state<K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)pass1_smem<K>());
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wkv_pass3_out<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)pass3_smem<K>());
  if (err == cudaSuccess) done |= 1ull << (dev & 63);
  return err;
}

template <int K>
int launch(const float* r, const float* k, const float* v, const float* lw,
           const float* u, const float* s0, float* out, float* s1,
           float* scratch, int64_t B, int64_t S, int64_t H,
           cudaStream_t stream) {
  const int64_t nc = (S + kChunk - 1) / kChunk, BH = B * H;
  float* dS = scratch;                  // (B, H, nc, K, K)
  float* s_in = dS + BH * nc * K * K;   // (B, H, nc, K, K)
  float* dec = s_in + BH * nc * K * K;  // (B, H, nc, K)
  cudaError_t err = configure<K>();
  if (err != cudaSuccess) return (int)err;
  wkv_pass1_state<K><<<(unsigned)(BH * nc), kThreads1, pass1_smem<K>(),
                       stream>>>(k, v, lw, dS, dec, S, H, (int)nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int64_t elems = BH * K * K;
  wkv_pass2_scan<K><<<(unsigned)((elems + kScanThreads - 1) / kScanThreads),
                      kScanThreads, 0, stream>>>(s0, dS, dec, s_in, s1, BH,
                                                 (int)nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  wkv_pass3_out<K><<<(unsigned)(BH * nc), kThreads3, pass3_smem<K>(),
                     stream>>>(r, k, v, lw, u, s_in, out, S, H, (int)nc);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v, lw: (B, S, H, K) float32; u: (H, K); s0: (B, H, K, K); out:
// (B, S, H, K); s1: (B, H, K, K) (may alias s0); scratch: B*H*nc*K*(2K+1)
// floats, nc = ceil(S / 64), laid out as dS (B, H, nc, K, K), S_{c-1}
// (B, H, nc, K, K), exp(Lend) (B, H, nc, K). All contiguous, on the
// device. K must be 16 (the smoke config) or 64 (rwkv6-3b); B * H >= 1 and
// S >= 1. Launches three kernels on the stream; returns cudaGetLastError()
// after the last launch, or the first error before it (0 = all launched).
extern "C" int wkv_chunk_launch(const float* r, const float* k,
                                const float* v, const float* lw,
                                const float* u, const float* s0, float* out,
                                float* s1, float* scratch, int64_t B,
                                int64_t S, int64_t H, int64_t K,
                                void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (K) {
    case 16:
      return launch<16>(r, k, v, lw, u, s0, out, s1, scratch, B, S, H, st);
    case 64:
      return launch<64>(r, k, v, lw, u, s0, out, s1, scratch, B, S, H, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
