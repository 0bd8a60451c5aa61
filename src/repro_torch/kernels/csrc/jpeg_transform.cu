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
// less than ~1.9 ms; a PyTorch float32 copy of the same bytes takes ~2.1
// ms on an H100, the kernel ~2.4 ms.
//
// Design (block8x8.cuh), the mirror of jpeg_inverse.cu: a persistent grid
// of warps, each walking 8 x 32 strips (four 8x8 blocks, all three
// channels), a strip's 24 loads a lane issued before any is used. Unlike
// the inverse it does not load the next strip ahead (kAhead = 0): with the
// 24 registers of a double buffer the kernel spills at its 128-register
// cap and ran 3-5 % slower on an H100; the other warps of the SM (16 a
// SM) hide the loads' latency instead.
//   1. lane l loads column l's R, G, B (each load one 128-B span across the
//      warp) and converts its 8 pixels to level-shifted Y, Cb, Cr;
//   2. pass 1 down the column: T[i][k] = sum_j C[i][j] X[j][k];
//   3. a warp-private transpose (padded shared memory, __syncwarp only):
//      lane 8b + i gets row i of block b;
//   4. pass 2 along the row: Y[i][l] = sum_k T[i][k] C[l][k], l = 0..7;
//   5. q = Y / Q with row i of each table (registers, loaded once per
//      warp), stored as int32 round-half-even: two 16-byte stores of the
//      row's eight coefficients per channel.
// Device memory sees each input and output byte exactly once. The
// quantization tables come in as a by-value kernel argument; the DCT
// matrix C is numpy's dct_matrix(), compiled in as immediates (never
// rebuilt here with cosf). Any H and W that are multiples of 8 work (no
// 128-lane rule). Reading tiles
// straight from the (3, H, W) level and fusing the next level's downsample
// are later work.
//
// Exactness: every product and sum is written with __fmul_rn / __fadd_rn /
// __fsub_rn and the division with __fdiv_rn, and the library is built with
// -fmad=false, so nothing is contracted into an FMA. The polynomial terms
// and both 8-term sums (the first product, then += for j or k = 1..7) run
// in the same order as the plain version (repro_torch/kernels/ref.py),
// which therefore matches this kernel bit for bit. rintf rounds half to
// even, like torch.round and jnp.round.
#include <stdint.h>

#include "block8x8.cuh"

namespace {

using namespace block8x8;

template <int kTile>
__global__ void __launch_bounds__(kThreads, 2)
jpeg_transform_kernel(const float* __restrict__ x, int* __restrict__ out,
                      Geometry g, Tables<3> tables) {
  __shared__ Buffer<3> bufs[kWarps];
  Buffer<3>& buf = bufs[threadIdx.x / 32];
  const int lane = threadIdx.x & 31;
  float q[3][8];  // row lane & 7 of each table: Q[ch][lane & 7][l]
#pragma unroll
  for (int ch = 0; ch < 3; ++ch)
#pragma unroll
    for (int l = 0; l < 8; ++l) q[ch][l] = tables.Q[ch][(lane & 7) * 8 + l];

  const Dims<kTile> d(g);
  walk<kTile, 0, 3>(x, g, [&](const Strip& s, const float (&px)[3][8]) {
    float t[3][8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float r = px[0][j], gr = px[1][j], bl = px[2][j];
      // y = 0.299 r + 0.587 g + 0.114 b - 128, left to right
      t[0][j] = __fsub_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(0.299f, r), __fmul_rn(0.587f, gr)),
                    __fmul_rn(0.114f, bl)),
          128.0f);
      // cb = -0.168736 r - 0.331264 g + 0.5 b
      t[1][j] = __fadd_rn(
          __fsub_rn(__fmul_rn(-0.168736f, r), __fmul_rn(0.331264f, gr)),
          __fmul_rn(0.5f, bl));
      // cr = 0.5 r - 0.418688 g - 0.081312 b
      t[2][j] = __fsub_rn(
          __fsub_rn(__fmul_rn(0.5f, r), __fmul_rn(0.418688f, gr)),
          __fmul_rn(0.081312f, bl));
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {  // pass 1, i = 0..7
      float col[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float acc = __fmul_rn(dct(i * 8), t[ch][0]);
#pragma unroll
        for (int j = 1; j < 8; ++j)
          acc = __fadd_rn(acc, __fmul_rn(dct(i * 8 + j), t[ch][j]));
        col[i] = acc;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) t[ch][i] = col[i];
    }
    transpose(buf, t, lane);
    const bool live = (lane & ~7) < s.width;  // block lane / 8 in the tile
    int* o = out + s.base + (lane & 7) * d.W + (lane & ~7);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {  // pass 2, l = 0..7, and quantize
      int v[8];
#pragma unroll
      for (int l = 0; l < 8; ++l) {
        float acc = __fmul_rn(t[ch][0], dct(l * 8));
#pragma unroll
        for (int k = 1; k < 8; ++k)
          acc = __fadd_rn(acc, __fmul_rn(t[ch][k], dct(l * 8 + k)));
        // A zero sum (most of a flat block's) quantizes to 0, as the
        // division would give it: it skips the division, whose range check
        // sends a zero dividend to its slow path (without this, slide
        // tiles took ~20 % longer than noise on an H100).
        const int k = (int)rintf(__fdiv_rn(acc == 0.0f ? 1.0f : acc,
                                           q[ch][l]));
        v[l] = acc == 0.0f ? 0 : k;
      }
      if (live) {
        int4* dst = reinterpret_cast<int4*>(o + ch * d.plane);
        __stcs(dst, make_int4(v[0], v[1], v[2], v[3]));
        __stcs(dst + 1, make_int4(v[4], v[5], v[6], v[7]));
      }
    }
  });
}

template <int kTile>
cudaError_t launch(const float* x, int* out, const Geometry& g,
                   const Tables<3>& tables, void* stream) {
  unsigned grid;
  const cudaError_t err =
      persistent_grid<jpeg_transform_kernel<kTile>>(g, &grid);
  if (err != cudaSuccess) return err;
  jpeg_transform_kernel<kTile><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, out, g, tables);
  return cudaGetLastError();
}

}  // namespace

// x: (N, 3, H, W) float32 holding u8 values, contiguous, on the device;
// out: (N, 3, H, W) int32, 16-byte aligned. q_host: 3 x 64 floats on the
// host, the Y, Cb and Cr quantization tables (a kernel argument). H and W
// must be multiples of 8. Returns cudaGetLastError() after the launch
// (0 = launched), or cudaErrorInvalidValue for a shape or output the
// kernel does not take.
extern "C" int jpeg_transform_launch(const float* x, int* out, int64_t N,
                                     int64_t H, int64_t W,
                                     const float* q_host, void* stream) {
  if (N == 0) return 0;
  Geometry g;
  if (!make_geometry<3>(out, N, H, W, &g)) return (int)cudaErrorInvalidValue;
  const Tables<3> tables = make_tables<3>(q_host);
  return (int)(H == kPipelineTile && W == kPipelineTile
                   ? launch<kPipelineTile>(x, out, g, tables, stream)
                   : launch<0>(x, out, g, tables, stream));
}
