// Whole-level fused JPEG transform: RGB -> level-shifted YCbCr -> 8x8 DCT-II
// -> quantize, for a (N, 3, H, W) batch of tiles in one launch.
//
// Replaces: src/repro/kernels/jpeg_transform.py, jpeg_transform_pallas (the
// TPU kernel; its grid is (N, T/8, T/128) of 8x128 VMEM strips with the
// 8x8 contractions on the MXU).
//
// Bound on this card: memory. Per pixel it reads three float32 channels
// (12 B) and writes three int32 coefficients (12 B), against ~100
// floating-point operations -- ~4 operations per byte, far below the ~20
// the card's float32 (non-tensor) rate needs before arithmetic would bind.
// At 3.35 TB/s a level of 4096 tiles of 256^2 (6.4 GB moved) cannot take
// less than ~1.9 ms.
//
// Design: one CTA of 64 x 8 threads covers an 8-row strip, 64 columns wide
// (eight 8x8 blocks side by side), of one tile and all three channels:
//   1. each thread loads its pixel's R, G, B (each warp reads one 128-B
//      span per channel) and writes Y, Cb, Cr to shared memory;
//   2. row pass T = C.X: thread (i, c) sums C[i][j] * X[j][c] over j;
//   3. column pass Y = T.C^T: thread (i, c) sums T[i][k] * C[c%8][k] over k;
//   4. q = Y / Q, stored as int32 round-half-even, one coalesced store per
//      channel.
// Pixels stay in shared memory between the passes, so device memory sees
// each input and output byte exactly once. The DCT matrix C and the three
// quantization tables come in as a by-value kernel argument (they are
// operands: C is numpy's dct_matrix(), never rebuilt here with cosf) and
// are staged into shared memory. Any H and W that are multiples of 8 work
// (no 128-lane rule): threads whose column lies past the tile edge only
// join the barriers.
// Wider loads, reading tiles straight from the (3, H, W) level and fusing
// the next level's downsample are later work.
//
// Exactness: every product and sum is written with __fmul_rn / __fadd_rn /
// __fsub_rn and the division with __fdiv_rn, and the library is built with
// -fmad=false, so nothing is contracted into an FMA. The polynomial terms
// and both 8-term sums run in the same order as the plain version
// (repro_torch/kernels/ref.py), which therefore matches this kernel bit for
// bit. rintf rounds half to even, like torch.round and jnp.round.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStripW = 64;  // columns per CTA (eight 8x8 blocks)

struct Operands {
  float C[64];     // DCT-II matrix, row-major: C[i * 8 + j]
  float Q[3][64];  // quantization tables for Y, Cb, Cr, row-major
};

__global__ void __launch_bounds__(kStripW * 8)
jpeg_transform_kernel(const float* __restrict__ x, int* __restrict__ out,
                      int64_t H, int64_t W, int64_t strips, Operands ops) {
  __shared__ float sC[64];
  __shared__ float sQ[3][64];
  __shared__ float px[3][8][kStripW];    // the strip's Y, Cb, Cr
  __shared__ float rows[3][8][kStripW];  // row pass result T = C.X

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kStripW + tx;
  if (tid < 64) {
    sC[tid] = ops.C[tid];
  } else if (tid < 64 + 3 * 64) {
    const int ch = (tid - 64) / 64, i = (tid - 64) % 64;
    sQ[ch][i] = ops.Q[ch][i];
  }

  const int64_t brows = H / 8;
  const int64_t b = blockIdx.x;
  const int64_t strip = b % strips;
  const int64_t rest = b / strips;
  const int64_t br = rest % brows;
  const int64_t n = rest / brows;
  const int64_t col = strip * kStripW + tx;
  const bool active = col < W;
  const int64_t plane = H * W;
  const int64_t off = n * 3 * plane + (br * 8 + ty) * W + col;

  if (active) {
    const float r = x[off], g = x[off + plane], bl = x[off + 2 * plane];
    // y = 0.299 r + 0.587 g + 0.114 b - 128, left to right
    px[0][ty][tx] = __fsub_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(0.299f, r), __fmul_rn(0.587f, g)),
                  __fmul_rn(0.114f, bl)),
        128.0f);
    // cb = -0.168736 r - 0.331264 g + 0.5 b
    px[1][ty][tx] = __fadd_rn(
        __fsub_rn(__fmul_rn(-0.168736f, r), __fmul_rn(0.331264f, g)),
        __fmul_rn(0.5f, bl));
    // cr = 0.5 r - 0.418688 g - 0.081312 b
    px[2][ty][tx] = __fsub_rn(
        __fsub_rn(__fmul_rn(0.5f, r), __fmul_rn(0.418688f, g)),
        __fmul_rn(0.081312f, bl));
  }
  __syncthreads();

  if (active) {  // row pass: T[i][k] = sum_j C[i][j] X[j][k], i = ty
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float acc = __fmul_rn(sC[ty * 8], px[ch][0][tx]);
#pragma unroll
      for (int j = 1; j < 8; ++j)
        acc = __fadd_rn(acc, __fmul_rn(sC[ty * 8 + j], px[ch][j][tx]));
      rows[ch][ty][tx] = acc;
    }
  }
  __syncthreads();

  if (active) {  // column pass: Y[i][l] = sum_k T[i][k] C[l][k]
    const int l = tx & 7;
    const int base = tx - l;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float acc = __fmul_rn(rows[ch][ty][base], sC[l * 8]);
#pragma unroll
      for (int k = 1; k < 8; ++k)
        acc = __fadd_rn(acc,
                        __fmul_rn(rows[ch][ty][base + k], sC[l * 8 + k]));
      const float q = sQ[ch][ty * 8 + l];
      out[off + ch * plane] = (int)rintf(__fdiv_rn(acc, q));
    }
  }
}

}  // namespace

// x: (N, 3, H, W) float32 holding u8 values, contiguous, on the device;
// out: (N, 3, H, W) int32. c_host: the 64 floats of the DCT matrix;
// q_host: 3 x 64 floats, the Y, Cb and Cr quantization tables (both on the
// host: they travel as kernel arguments). H and W must be multiples of 8.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int jpeg_transform_launch(const float* x, int* out, int64_t N,
                                     int64_t H, int64_t W,
                                     const float* c_host,
                                     const float* q_host, void* stream) {
  if (N == 0) return 0;
  if (H <= 0 || W <= 0 || H % 8 || W % 8)
    return (int)cudaErrorInvalidValue;
  Operands ops;
  for (int i = 0; i < 64; ++i) ops.C[i] = c_host[i];
  for (int c = 0; c < 3; ++c)
    for (int i = 0; i < 64; ++i) ops.Q[c][i] = q_host[c * 64 + i];
  const int64_t strips = (W + kStripW - 1) / kStripW;
  const int64_t blocks = N * (H / 8) * strips;
  jpeg_transform_kernel<<<(unsigned)blocks, dim3(kStripW, 8), 0,
                          (cudaStream_t)stream>>>(x, out, H, W, strips,
                                                  ops);
  return (int)cudaGetLastError();
}
