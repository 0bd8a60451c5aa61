// Whole-level fused inverse JPEG transform: dequantize -> 8x8 inverse DCT
// -> YCbCr to RGB (+128) -> clip(round) to u8, for a (N, 3, H, W) batch of
// coefficient tiles in one launch.
//
// Replaces: src/repro/kernels/jpeg_inverse.py, jpeg_inverse_pallas (the TPU
// kernel; its grid is (N, T/8, T/128) of 8x128 VMEM strips with the two
// 8x8 contractions on the MXU, writing int32 that the wrapper casts to u8).
//
// Bound on this card: memory. Per pixel it reads three int32 coefficients
// (12 B) and writes three u8 samples (3 B), against ~110 floating-point
// operations -- ~7 operations per byte, below the ~20 the card's float32
// (non-tensor) rate needs before arithmetic would bind. At 3.35 TB/s a
// level of 4096 tiles of 256^2 (3.22 GB in, 0.81 GB out) cannot take less
// than ~1.2 ms.
//
// Design: the mirror of jpeg_transform.cu. One CTA of 64 x 8 threads
// covers an 8-row strip, 64 columns wide (eight 8x8 blocks side by side),
// of one tile and all three channels:
//   1. each thread loads its position's three coefficients (each warp reads
//      one 128-B span per channel), multiplies by the channel's
//      quantization entry and writes them to shared memory;
//   2. row pass T = C^T.X: thread (i, c) sums C[j][i] * X[j][c] over j;
//   3. column pass Y = T.C: thread (i, c) sums T[i][k] * C[k][c%8] over k;
//   4. the thread now holds Y, Cb, Cr of its own pixel: the inverse
//      polynomials, rintf, clamp to [0, 255], and one u8 store per channel
//      (each warp writes one 32-B span per channel).
// Device memory sees each input and output byte once. The output is u8
// directly: the TPU kernel's int32 output existed only for its tiling. The
// DCT matrix C and the three tables come in as a by-value kernel argument
// (C is numpy's dct_matrix(), never rebuilt here with cosf). Any H and W
// that are multiples of 8 work (no 128-lane rule).
//
// Exactness: every product and sum is written with __fmul_rn / __fadd_rn /
// __fsub_rn and the library is built with -fmad=false, so nothing is
// contracted into an FMA. The dequantize, both 8-term sums and the
// polynomial terms run in the same order as the plain version
// (repro_torch/kernels/ref.py, jpeg_inverse_ref), which therefore matches
// this kernel bit for bit. rintf rounds half to even, like torch.round.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStripW = 64;  // columns per CTA (eight 8x8 blocks)

struct Operands {
  float C[64];     // DCT-II matrix, row-major: C[i * 8 + j]
  float Q[3][64];  // quantization tables for Y, Cb, Cr, row-major
};

__device__ __forceinline__ uint8_t to_u8(float v) {
  return (uint8_t)fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}

__global__ void __launch_bounds__(kStripW * 8)
jpeg_inverse_kernel(const int* __restrict__ coef, uint8_t* __restrict__ out,
                    int64_t H, int64_t W, int64_t strips, Operands ops) {
  __shared__ float sC[64];
  __shared__ float sQ[3][64];
  __shared__ float px[3][8][kStripW];    // the strip's dequantized blocks
  __shared__ float rows[3][8][kStripW];  // row pass result T = C^T.X

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kStripW + tx;
  if (tid < 64) {
    sC[tid] = ops.C[tid];
  } else if (tid < 64 + 3 * 64) {
    const int ch = (tid - 64) / 64, i = (tid - 64) % 64;
    sQ[ch][i] = ops.Q[ch][i];
  }
  __syncthreads();

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
  const int l = tx & 7;

  if (active) {  // dequantize: X = coef * Q, exact for in-range values
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      px[ch][ty][tx] = __fmul_rn((float)coef[off + ch * plane],
                                 sQ[ch][ty * 8 + l]);
  }
  __syncthreads();

  if (active) {  // row pass: T[i][k] = sum_j C[j][i] X[j][k], i = ty
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float acc = __fmul_rn(sC[ty], px[ch][0][tx]);
#pragma unroll
      for (int j = 1; j < 8; ++j)
        acc = __fadd_rn(acc, __fmul_rn(sC[j * 8 + ty], px[ch][j][tx]));
      rows[ch][ty][tx] = acc;
    }
  }
  __syncthreads();

  if (active) {  // column pass: Y[i][l] = sum_k T[i][k] C[k][l]
    const int base = tx - l;
    float y[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float acc = __fmul_rn(rows[ch][ty][base], sC[l]);
#pragma unroll
      for (int k = 1; k < 8; ++k)
        acc = __fadd_rn(acc, __fmul_rn(rows[ch][ty][base + k], sC[k * 8 + l]));
      y[ch] = acc;
    }
    // y += 128; r = y + 1.402 cr; g = y - 0.344136 cb - 0.714136 cr;
    // b = y + 1.772 cb -- left to right
    const float yy = __fadd_rn(y[0], 128.0f);
    const float r = __fadd_rn(yy, __fmul_rn(1.402f, y[2]));
    const float g = __fsub_rn(__fsub_rn(yy, __fmul_rn(0.344136f, y[1])),
                              __fmul_rn(0.714136f, y[2]));
    const float bl = __fadd_rn(yy, __fmul_rn(1.772f, y[1]));
    out[off] = to_u8(r);
    out[off + plane] = to_u8(g);
    out[off + 2 * plane] = to_u8(bl);
  }
}

}  // namespace

// coef: (N, 3, H, W) int32, contiguous, on the device; out: (N, 3, H, W)
// u8. c_host: the 64 floats of the DCT matrix; q_host: 3 x 64 floats, the
// Y, Cb and Cr quantization tables (both on the host: they travel as
// kernel arguments). H and W must be multiples of 8.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int jpeg_inverse_launch(const int* coef, uint8_t* out, int64_t N,
                                   int64_t H, int64_t W, const float* c_host,
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
  jpeg_inverse_kernel<<<(unsigned)blocks, dim3(kStripW, 8), 0,
                        (cudaStream_t)stream>>>(coef, out, H, W, strips, ops);
  return (int)cudaGetLastError();
}
