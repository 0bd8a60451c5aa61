// Blockwise 8x8 DCT-II + quantization of one (H, W) plane: the per-tile
// encode path's transform, called once per channel.
//
// Replaces: src/repro/kernels/dct8x8_quant.py, dct8x8_quant_pallas (the TPU
// kernel; (8, 128) VMEM blocks reshaped to 16 DCT blocks for the MXU, with
// C rebuilt in the kernel from iota -> cos).
//
// Bound on this card: memory. Per pixel it reads one float32 (4 B) and
// writes one int32 (4 B), against ~32 floating-point operations. A 16384^2
// plane (2.1 GB moved) cannot take less than ~0.64 ms at 3.35 TB/s; a 256^2
// plane (0.5 MB) ~0.16 us, far below one launch: on the per-tile path the
// launch is the cost.
//
// Design (block8x8.cuh with one channel, kCh = 1, N = 1): jpeg_transform.cu
// without its colour conversion. A persistent grid of warps walks the
// plane's 8 x 32 strips (four 8x8 blocks side by side):
//   1. lane l loads column l's 8 samples (scalar __ldcs: any 4-byte offset
//      is taken, so the (3, H, W) colour planes' views launch as they are);
//      the next strip's 8 loads are issued before this strip is computed
//      (kAhead = 1: with 8 samples a lane, not the transform's 24, the
//      double buffer costs 8 registers);
//   2. pass 1 down the column: T[i][k] = sum_j C[i][j] X[j][k];
//   3. a warp-private transpose (padded shared memory, __syncwarp only):
//      lane 8b + i gets row i of block b;
//   4. pass 2 along the row: Y[i][l] = sum_k T[i][k] C[l][k], l = 0..7;
//   5. q = Y / Q with row i of the table (registers, loaded once per warp),
//      stored as int32 round-half-even: two 16-byte stores a lane.
// C is numpy's dct_matrix(), compiled in as immediates (BLOCK8X8_DCT_MATRIX;
// the launcher takes no C); the table is a by-value kernel argument. A
// 256^2 instance has its in-strip offsets as immediates; another takes any
// H and W that are multiples of 8.
//
// Loads in flight: a warp keeps its next strip's 8 x 128 B in flight, so
// the generic instance's 3 CTAs of 8 warps an SM hold 24 KB at a large
// plane; the card's ~3.35 TB/s at ~0.7 us of DRAM latency needs some
// 18-25 KB an SM. A 256^2 tile is one strip a warp: there the grid's
// spread over the SMs, not the look-ahead, sets the time.
//
// Exactness: the sums run in the order of jpeg_transform.cu and of the
// plain version (ref.py, dct8x8_quant_ref), with __fmul_rn / __fadd_rn /
// __fdiv_rn and -fmad=false, so a tile's per-tile coefficients equal its
// whole-level ones and the plain version's bit for bit. rintf rounds half
// to even, like torch.round.
#include <stdint.h>

#include "block8x8.cuh"

namespace {

using namespace block8x8;

// Warps a CTA, and CTAs an SM that the register budget must allow
// (__launch_bounds__). The 256^2 instance: CTAs of kTileWarps warps, so
// that a tile's 256 strips (one a warp) spread over every SM instead of
// filling 32 CTAs of 8 warps; 32 warps an SM (at most 64 registers a
// thread). On an H100 a tile took 1.94-1.96 us at 1 warp a CTA, 1.94 at
// 2, 2.05 at 4 and 2.43 at 8 (PERF.md §6). The generic one: CTAs of 8
// warps, 3 an SM (at most 80 registers; it spills at 64).
constexpr int kTileWarps = 1;
template <int kTile>
constexpr int kCtaWarps = kTile ? kTileWarps : kWarps;
template <int kTile>
constexpr int kMinCtas = kTile ? 32 / kTileWarps : 3;

template <int kTile>
__global__ void __launch_bounds__(32 * kCtaWarps<kTile>, kMinCtas<kTile>)
dct8x8_quant_kernel(const float* __restrict__ x, int* __restrict__ out,
                    Geometry g, Tables<1> table) {
  __shared__ Buffer<1> bufs[kCtaWarps<kTile>];
  Buffer<1>& buf = bufs[threadIdx.x / 32];
  const int lane = threadIdx.x & 31;
  float q[8];  // row lane & 7 of the table: Q[lane & 7][l]
#pragma unroll
  for (int l = 0; l < 8; ++l) q[l] = table.Q[0][(lane & 7) * 8 + l];

  const Dims<kTile> d(g);
  walk<kTile, 1, 1, kCtaWarps<kTile>>(x, g, [&](const Strip& s,
                                                const float (&px)[1][8]) {
    float t[1][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // pass 1, i = 0..7
      float acc = __fmul_rn(dct(i * 8), px[0][0]);
#pragma unroll
      for (int j = 1; j < 8; ++j)
        acc = __fadd_rn(acc, __fmul_rn(dct(i * 8 + j), px[0][j]));
      t[0][i] = acc;
    }
    transpose(buf, t, lane);
    int v[8];
#pragma unroll
    for (int l = 0; l < 8; ++l) {  // pass 2, l = 0..7, and quantize
      float acc = __fmul_rn(t[0][0], dct(l * 8));
#pragma unroll
      for (int k = 1; k < 8; ++k)
        acc = __fadd_rn(acc, __fmul_rn(t[0][k], dct(l * 8 + k)));
      // A zero sum (most of a flat block's) quantizes to 0, as the
      // division would give it; it skips the division, whose range check
      // sends a zero dividend to its slow path (jpeg_transform.cu).
      const int k = (int)rintf(__fdiv_rn(acc == 0.0f ? 1.0f : acc, q[l]));
      v[l] = acc == 0.0f ? 0 : k;
    }
    if ((lane & ~7) < s.width) {  // block lane / 8 lies inside the plane
      int4* dst = reinterpret_cast<int4*>(out + s.base + (lane & 7) * d.W +
                                          (lane & ~7));
      __stcs(dst, make_int4(v[0], v[1], v[2], v[3]));
      __stcs(dst + 1, make_int4(v[4], v[5], v[6], v[7]));
    }
  });
}

template <int kTile>
cudaError_t launch(const float* x, int* out, const Geometry& g,
                   const Tables<1>& table, void* stream) {
  unsigned grid;
  const cudaError_t err =
      persistent_grid<dct8x8_quant_kernel<kTile>, kCtaWarps<kTile>>(g,
                                                                    &grid);
  if (err != cudaSuccess) return err;
  dct8x8_quant_kernel<kTile>
      <<<grid, 32 * kCtaWarps<kTile>, 0, (cudaStream_t)stream>>>(x, out, g,
                                                                 table);
  return cudaGetLastError();
}

}  // namespace

// x: (H, W) float32 level-shifted plane, contiguous, on the device (any
// 4-byte offset); out: (H, W) int32, 16-byte aligned. q_host: the 64 floats
// of the quantization table, row-major, on the host (a kernel argument).
// H and W must be multiples of 8. Returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for a shape or output the
// kernel does not take.
extern "C" int dct8x8_quant_launch(const float* x, int* out, int64_t H,
                                   int64_t W, const float* q_host,
                                   void* stream) {
  if (H == 0 || W == 0) return 0;
  Geometry g;
  if (!make_geometry<1>(out, 1, H, W, &g)) return (int)cudaErrorInvalidValue;
  const Tables<1> table = make_tables<1>(q_host);
  return (int)(H == kPipelineTile && W == kPipelineTile
                   ? launch<kPipelineTile>(x, out, g, table, stream)
                   : launch<0>(x, out, g, table, stream));
}
