// Blockwise 8x8 DCT-II + quantization of one (H, W) plane: the per-tile
// encode path's transform, called once per channel.
//
// Replaces: src/repro/kernels/dct8x8_quant.py, dct8x8_quant_pallas (the TPU
// kernel; (8, 128) VMEM blocks reshaped to 16 DCT blocks for the MXU, with
// C rebuilt in the kernel from iota -> cos).
//
// Bound on this card: memory. Per pixel it reads one float32 (4 B) and
// writes one int32 (4 B), against ~32 floating-point operations. A 256^2
// plane (0.5 MB moved) cannot take less than ~0.16 us at 3.35 TB/s, far
// below one launch's overhead: on the per-tile path the launch is the cost.
//
// Design: jpeg_transform.cu with one channel. One CTA of 64 x 8 threads
// covers an 8-row strip, 64 columns wide (eight 8x8 blocks side by side):
//   1. each thread loads its sample into shared memory;
//   2. row pass T = C.X: thread (i, c) sums C[i][j] * X[j][c] over j;
//   3. column pass Y = T.C^T: thread (i, c) sums T[i][k] * C[c%8][k] over k;
//   4. q = Y / Q, stored as int32 round-half-even.
// The DCT matrix is numpy's dct_matrix(), passed by value with the table:
// the TPU kernel's float32 cosine differs from it in the last ULP.
//
// Exactness: the sums run in the order of jpeg_transform.cu and of the
// plain version (ref.py, dct8x8_quant_ref), with __fmul_rn / __fadd_rn /
// __fdiv_rn and -fmad=false, so a tile's per-tile coefficients equal its
// whole-level ones and the plain version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStripW = 64;  // columns per CTA (eight 8x8 blocks)

struct Operands {
  float C[64];  // DCT-II matrix, row-major: C[i * 8 + j]
  float Q[64];  // quantization table, row-major
};

__global__ void __launch_bounds__(kStripW * 8)
dct8x8_quant_kernel(const float* __restrict__ x, int* __restrict__ out,
                    int64_t W, int64_t strips, Operands ops) {
  __shared__ float sC[64];
  __shared__ float sQ[64];
  __shared__ float px[8][kStripW];
  __shared__ float rows[8][kStripW];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kStripW + tx;
  if (tid < 64) {
    sC[tid] = ops.C[tid];
  } else if (tid < 128) {
    sQ[tid - 64] = ops.Q[tid - 64];
  }

  const int64_t b = blockIdx.x;
  const int64_t strip = b % strips;
  const int64_t br = b / strips;
  const int64_t col = strip * kStripW + tx;
  const bool active = col < W;
  const int64_t off = (br * 8 + ty) * W + col;

  if (active) px[ty][tx] = x[off];
  __syncthreads();

  if (active) {  // row pass: T[i][k] = sum_j C[i][j] X[j][k], i = ty
    float acc = __fmul_rn(sC[ty * 8], px[0][tx]);
#pragma unroll
    for (int j = 1; j < 8; ++j)
      acc = __fadd_rn(acc, __fmul_rn(sC[ty * 8 + j], px[j][tx]));
    rows[ty][tx] = acc;
  }
  __syncthreads();

  if (active) {  // column pass: Y[i][l] = sum_k T[i][k] C[l][k]
    const int l = tx & 7;
    const int base = tx - l;
    float acc = __fmul_rn(rows[ty][base], sC[l * 8]);
#pragma unroll
    for (int k = 1; k < 8; ++k)
      acc = __fadd_rn(acc, __fmul_rn(rows[ty][base + k], sC[l * 8 + k]));
    out[off] = (int)rintf(__fdiv_rn(acc, sQ[ty * 8 + l]));
  }
}

}  // namespace

// x: (H, W) float32 level-shifted plane, contiguous, on the device; out:
// (H, W) int32. c_host: the 64 floats of the DCT matrix; q_host: the 64
// floats of the quantization table (both on the host: they travel as
// kernel arguments). H and W must be multiples of 8.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int dct8x8_quant_launch(const float* x, int* out, int64_t H,
                                   int64_t W, const float* c_host,
                                   const float* q_host, void* stream) {
  if (H == 0 || W == 0) return 0;
  if (H < 0 || W < 0 || H % 8 || W % 8) return (int)cudaErrorInvalidValue;
  Operands ops;
  for (int i = 0; i < 64; ++i) ops.C[i] = c_host[i];
  for (int i = 0; i < 64; ++i) ops.Q[i] = q_host[i];
  const int64_t strips = (W + kStripW - 1) / kStripW;
  const int64_t blocks = (H / 8) * strips;
  dct8x8_quant_kernel<<<(unsigned)blocks, dim3(kStripW, 8), 0,
                        (cudaStream_t)stream>>>(x, out, W, strips, ops);
  return (int)cudaGetLastError();
}
