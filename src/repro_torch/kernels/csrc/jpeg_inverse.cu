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
// than ~1.2 ms; a PyTorch int32 -> u8 copy of the same bytes takes ~1.4 ms
// on an H100, this kernel ~1.5 ms. Without FMA (exactness, below) a
// product and a sum are two issue slots, so the arithmetic needs most of
// the SM's issue rate at that bandwidth: the kernel spends as few integer
// instructions per sample as it can (offsets inside a 256^2 tile are
// immediates) and keeps the next strip's loads in flight (kAhead = 1: 7 %
// faster than without).
//
// Design (block8x8.cuh): a persistent grid of warps, each walking 8 x 32
// strips (four 8x8 blocks, all three channels) with the next strip's 24
// loads a lane in flight while it computes the current one:
//   1. lane l loads column l (each load one 128-B span across the warp)
//      and dequantizes it with its column's table entries, Q[ch][j][l & 7],
//      held in registers for the life of the warp;
//   2. pass 1 down the column: T[i][k] = sum_j C[j][i] X[j][k];
//   3. a warp-private transpose (padded shared memory, __syncwarp only):
//      lane 8b + i gets row i of block b;
//   4. pass 2 along the row: Y[i][l] = sum_k T[i][k] C[k][l], l = 0..7;
//   5. the inverse polynomials, rintf, clamp to [0, 255], and one 8-byte
//      store of the row's eight samples per channel.
// Device memory sees each input and output byte once. The output is u8
// directly: the TPU kernel's int32 output existed only for its tiling. The
// quantization tables come in as a by-value kernel argument; the DCT matrix
// C is numpy's dct_matrix(), compiled in as immediates (never rebuilt here
// with cosf). Any H and W that are multiples of 8 work (no 128-lane
// rule).
//
// Exactness: every product and sum is written with __fmul_rn / __fadd_rn /
// __fsub_rn and the library is built with -fmad=false, so nothing is
// contracted into an FMA. The dequantize, both 8-term sums (the first
// product, then += for j or k = 1..7) and the polynomial terms run in the
// same order as the plain version (repro_torch/kernels/ref.py,
// jpeg_inverse_ref), which therefore matches this kernel bit for bit.
// rintf rounds half to even, like torch.round.
#include <stdint.h>

#include "block8x8.cuh"

namespace {

using namespace block8x8;

__device__ __forceinline__ uint32_t to_u8(float v) {
  return (uint32_t)fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}

__device__ __forceinline__ uint2 pack8(const float (&v)[8]) {
  return make_uint2(
      to_u8(v[0]) | to_u8(v[1]) << 8 | to_u8(v[2]) << 16 | to_u8(v[3]) << 24,
      to_u8(v[4]) | to_u8(v[5]) << 8 | to_u8(v[6]) << 16 | to_u8(v[7]) << 24);
}

template <int kTile>
__global__ void __launch_bounds__(kThreads, 2)
jpeg_inverse_kernel(const int* __restrict__ coef, uint8_t* __restrict__ out,
                    Geometry g, Tables<3> tables) {
  __shared__ Buffer<3> bufs[kWarps];
  Buffer<3>& buf = bufs[threadIdx.x / 32];
  const int lane = threadIdx.x & 31;
  float q[3][8];  // this lane's column of each table: Q[ch][j][lane & 7]
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
#pragma unroll
    for (int j = 0; j < 8; ++j) q[ch][j] = tables.Q[ch][j * 8 + (lane & 7)];

  const Dims<kTile> d(g);
  walk<kTile, 1, 3>(coef, g, [&](const Strip& s, const int (&x)[3][8]) {
    float t[3][8];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {  // pass 1, i = 0..7, X = coef * Q
      float xq[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        xq[j] = __fmul_rn((float)x[ch][j], q[ch][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float acc = __fmul_rn(dct(i), xq[0]);
#pragma unroll
        for (int j = 1; j < 8; ++j)
          acc = __fadd_rn(acc, __fmul_rn(dct(j * 8 + i), xq[j]));
        t[ch][i] = acc;
      }
    }
    transpose(buf, t, lane);
    float y[3][8];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)  // pass 2, l = 0..7
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        float acc = __fmul_rn(t[ch][0], dct(l));
#pragma unroll
        for (int k = 1; k < 8; ++k)
          acc = __fadd_rn(acc, __fmul_rn(t[ch][k], dct(k * 8 + l)));
        y[ch][l] = acc;
      }
    // y += 128; r = y + 1.402 cr; g = y - 0.344136 cb - 0.714136 cr;
    // b = y + 1.772 cb -- left to right
    float r[8], gr[8], bl[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const float yy = __fadd_rn(y[0][l], 128.0f);
      r[l] = __fadd_rn(yy, __fmul_rn(1.402f, y[2][l]));
      gr[l] = __fsub_rn(__fsub_rn(yy, __fmul_rn(0.344136f, y[1][l])),
                        __fmul_rn(0.714136f, y[2][l]));
      bl[l] = __fadd_rn(yy, __fmul_rn(1.772f, y[1][l]));
    }
    if ((lane & ~7) < s.width) {  // block lane / 8 lies inside the tile
      uint8_t* o = out + s.base + (lane & 7) * d.W + (lane & ~7);
      __stcs(reinterpret_cast<uint2*>(o), pack8(r));
      __stcs(reinterpret_cast<uint2*>(o + d.plane), pack8(gr));
      __stcs(reinterpret_cast<uint2*>(o + 2 * d.plane), pack8(bl));
    }
  });
}

template <int kTile>
cudaError_t launch(const int* coef, uint8_t* out, const Geometry& g,
                   const Tables<3>& tables, void* stream) {
  unsigned grid;
  const cudaError_t err =
      persistent_grid<jpeg_inverse_kernel<kTile>>(g, &grid);
  if (err != cudaSuccess) return err;
  jpeg_inverse_kernel<kTile><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      coef, out, g, tables);
  return cudaGetLastError();
}

}  // namespace

// coef: (N, 3, H, W) int32, contiguous, on the device; out: (N, 3, H, W)
// u8, 16-byte aligned. q_host: 3 x 64 floats on the host, the Y, Cb and Cr
// quantization tables (a kernel argument). H and W must be multiples of 8.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a shape or output the kernel does not take.
extern "C" int jpeg_inverse_launch(const int* coef, uint8_t* out, int64_t N,
                                   int64_t H, int64_t W, const float* q_host,
                                   void* stream) {
  if (N == 0) return 0;
  Geometry g;
  if (!make_geometry<3>(out, N, H, W, &g)) return (int)cudaErrorInvalidValue;
  const Tables<3> tables = make_tables<3>(q_host);
  return (int)(H == kPipelineTile && W == kPipelineTile
                   ? launch<kPipelineTile>(coef, out, g, tables, stream)
                   : launch<0>(coef, out, g, tables, stream));
}
