// One pyramid step: 2x2 box mean, stride 2, re-quantized to u8 values.
//
// Replaces: src/repro/kernels/downsample2x2.py, downsample2x2_pallas (the
// TPU kernel), together with the clip(round(.), 0, 255) that the pyramid
// chain applies to its output (src/repro/wsi/convert.py, _pyramid_chain and
// _convert_sync). The two are fused here: one pass over the level.
//
// Bound on this card: memory. Each output element reads four float32 taps
// (16 B) and writes one float32 (4 B) -- 5 B of traffic per input pixel and
// channel, against 5 floating-point operations. At 3.35 TB/s a 16384^2 RGB
// level (3.2 GB in, 0.8 GB out) cannot take less than ~1.2 ms.
//
// Design: one thread per output element of (C, H/2, W/2), consecutive
// threads on consecutive output columns, so the two input rows a warp reads
// are each one contiguous 256-B span and the store is one contiguous 128-B
// span. No shared memory: every input element is read exactly once. Wider
// (16-B) loads are later work.
//
// Exactness: the taps are summed in the reference's order
// (x[0::2,0::2] + x[1::2,0::2] + x[0::2,1::2] + x[1::2,1::2]), times 0.25,
// then rintf -- round half to even, like jnp.round / torch.round; roundf
// would round half away from zero and be wrong on every sum = 2 (mod 4) --
// then clamped to [0, 255]. Inputs are exact integers, so the result equals
// the plain version bit for bit. Built with -fmad=false, and the adds and the
// multiply are written with the _rn intrinsics, so nothing is contracted.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void downsample2x2_q_kernel(const float* __restrict__ x,
                                       float* __restrict__ out,
                                       int64_t H, int64_t W,
                                       int64_t Ho, int64_t Wo,
                                       int64_t total) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int64_t ox = i % Wo;
  int64_t rest = i / Wo;
  int64_t oy = rest % Ho;
  int64_t c = rest / Ho;
  const float* p = x + (c * H + 2 * oy) * W + 2 * ox;
  float a = p[0];      // x[2y,   2x]
  float b = p[W];      // x[2y+1, 2x]
  float d = p[1];      // x[2y,   2x+1]
  float e = p[W + 1];  // x[2y+1, 2x+1]
  float s = __fadd_rn(__fadd_rn(__fadd_rn(a, b), d), e);
  float m = rintf(__fmul_rn(0.25f, s));
  out[i] = fminf(fmaxf(m, 0.0f), 255.0f);
}

}  // namespace

// x: (C, H, W) float32, contiguous, on the device; out: (C, H/2, W/2).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int downsample2x2_q_launch(const float* x, float* out, int64_t C,
                                      int64_t H, int64_t W, void* stream) {
  int64_t Ho = H / 2, Wo = W / 2;
  int64_t total = C * Ho * Wo;
  if (total == 0) return 0;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  downsample2x2_q_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(x, out, H, W, Ho, Wo,
                                                   total);
  return (int)cudaGetLastError();
}
