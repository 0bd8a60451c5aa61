// RGB -> level-shifted YCbCr planes, elementwise: the per-tile encode path's
// colour conversion.
//
// Replaces: src/repro/kernels/rgb2ycbcr.py, rgb2ycbcr_pallas (the TPU
// kernel; (3, 8, 128) VMEM blocks, one VREG tile per channel).
//
// Bound on this card: memory. Per pixel it reads three float32 channels
// (12 B) and writes three (12 B), against 15 floating-point operations. A
// 256^2 tile (1.6 MB moved) cannot take less than ~0.5 us at 3.35 TB/s, far
// below one launch's overhead: on the per-tile path the launch, not the
// bytes, is the cost.
//
// Design: one thread per pixel, consecutive threads on consecutive columns,
// so each warp reads and writes one 128-B span per channel; no shared
// memory; any 4-byte offset and any H * W are taken. The whole-level path
// fuses this into jpeg_transform.cu. On an H100 (PERF.md §6) 16-byte
// float4 pieces were no faster at a 3 x 16384^2 level (this kernel is
// within 3 % of a copy of its bytes there) and slower at a 256^2 tile, so
// this kernel has no vector path.
//
// Exactness: the polynomial terms are written with __fmul_rn / __fadd_rn /
// __fsub_rn in the order of the plain version (ref.py, ycbcr_polynomials,
// the same expressions as jpeg_transform.cu) and the library is built with
// -fmad=false, so the output equals the plain version bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void rgb2ycbcr_kernel(const float* __restrict__ x,
                                 float* __restrict__ out, int64_t plane) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= plane) return;
  const float r = x[i], g = x[i + plane], b = x[i + 2 * plane];
  // y = 0.299 r + 0.587 g + 0.114 b - 128, left to right
  out[i] = __fsub_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(0.299f, r), __fmul_rn(0.587f, g)),
                __fmul_rn(0.114f, b)),
      128.0f);
  // cb = -0.168736 r - 0.331264 g + 0.5 b
  out[i + plane] = __fadd_rn(
      __fsub_rn(__fmul_rn(-0.168736f, r), __fmul_rn(0.331264f, g)),
      __fmul_rn(0.5f, b));
  // cr = 0.5 r - 0.418688 g - 0.081312 b
  out[i + 2 * plane] = __fsub_rn(
      __fsub_rn(__fmul_rn(0.5f, r), __fmul_rn(0.418688f, g)),
      __fmul_rn(0.081312f, b));
}

}  // namespace

// x: (3, H, W) float32 RGB, contiguous, on the device; out: (3, H, W)
// float32 Y - 128, Cb, Cr. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int rgb2ycbcr_launch(const float* x, float* out, int64_t H,
                                int64_t W, void* stream) {
  const int64_t plane = H * W;
  if (plane == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (plane + threads - 1) / threads;
  rgb2ycbcr_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      x, out, plane);
  return (int)cudaGetLastError();
}
