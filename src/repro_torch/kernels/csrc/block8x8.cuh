// The skeleton that jpeg_transform.cu, jpeg_inverse.cu and dct8x8_quant.cu
// share: a persistent grid of warps that walk 8-row x 32-column strips of a
// (N, kCh, H, W) batch of tiles, and the warp-private transpose between an
// 8x8 transform's two passes. kCh is the channel count: 3 for the block
// kernels' YCbCr tiles, 1 for dct8x8_quant's single plane (N = 1).
//
// A warp owns one strip at a time: four 8x8 blocks side by side, all kCh
// channels. Lane l owns column l of the strip; it loads its 8 kCh samples
// (8 rows x kCh channels; each load instruction reads one 128-B span across
// the warp) and sums down its column (pass 1). transpose() then hands lane
// 8b + i row i of block b, which it sums along (pass 2) and stores as one
// 8-sample run per channel. No block barrier: the transpose goes through
// the warp's own padded shared-memory buffer with __syncwarp only.
//
// walk() can keep the next strip's loads in flight while the current strip
// is computed (a register double buffer) and steps from strip to strip with
// carry additions, so no index math divides after a warp's first strip.
// Inside a tile all offsets are 32-bit; the tile's base is 64-bit, once per
// strip. A strip whose block row ends before its 32 columns (W a multiple
// of 8 but not of 32) masks the missing columns' loads and blocks' stores.
//
// Each kernel has two instances: kTile = kPipelineTile for the pipeline's
// 256 x 256 tiles, where every offset inside a strip is a compile-time
// constant (an instruction immediate: one instruction a load or store, no
// address arithmetic), and kTile = 0 for any other H and W, read from the
// Geometry at run time.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace block8x8 {

constexpr int kWarps = 8;              // warps per CTA (the default)
constexpr int kThreads = 32 * kWarps;  // threads per CTA
constexpr int kStripW = 32;            // columns per strip (four blocks)
constexpr int kPitch = kStripW + 1;    // padded row of the transpose buffer
constexpr int kPipelineTile = 256;     // the converter's and study's tiles

// The DCT-II matrix C, row-major (C[i * 8 + j]): numpy's dct_matrix()
// (repro_torch/kernels/ref.py) in float32, bit for bit (a CPU test holds
// these literals to it). The kernels take its entries as instruction
// immediates: no register, load or constant-bank read is spent on them,
// and the compiler cannot hoist them into registers.
#define BLOCK8X8_DCT_MATRIX                                                   \
  {0x1.6a09e6p-2f,  0x1.6a09e6p-2f,  0x1.6a09e6p-2f,  0x1.6a09e6p-2f,        \
   0x1.6a09e6p-2f,  0x1.6a09e6p-2f,  0x1.6a09e6p-2f,  0x1.6a09e6p-2f,        \
   0x1.f6297cp-2f,  0x1.a9b662p-2f,  0x1.1c73b4p-2f,  0x1.8f8b84p-4f,        \
   -0x1.8f8b84p-4f, -0x1.1c73b4p-2f, -0x1.a9b662p-2f, -0x1.f6297cp-2f,       \
   0x1.d906bcp-2f,  0x1.87de2ap-3f,  -0x1.87de2ap-3f, -0x1.d906bcp-2f,       \
   -0x1.d906bcp-2f, -0x1.87de2ap-3f, 0x1.87de2ap-3f,  0x1.d906bcp-2f,        \
   0x1.a9b662p-2f,  -0x1.8f8b84p-4f, -0x1.f6297cp-2f, -0x1.1c73b4p-2f,       \
   0x1.1c73b4p-2f,  0x1.f6297cp-2f,  0x1.8f8b84p-4f,  -0x1.a9b662p-2f,       \
   0x1.6a09e6p-2f,  -0x1.6a09e6p-2f, -0x1.6a09e6p-2f, 0x1.6a09e6p-2f,        \
   0x1.6a09e6p-2f,  -0x1.6a09e6p-2f, -0x1.6a09e6p-2f, 0x1.6a09e6p-2f,        \
   0x1.1c73b4p-2f,  -0x1.f6297cp-2f, 0x1.8f8b84p-4f,  0x1.a9b662p-2f,        \
   -0x1.a9b662p-2f, -0x1.8f8b84p-4f, 0x1.f6297cp-2f,  -0x1.1c73b4p-2f,       \
   0x1.87de2ap-3f,  -0x1.d906bcp-2f, 0x1.d906bcp-2f,  -0x1.87de2ap-3f,       \
   -0x1.87de2ap-3f, 0x1.d906bcp-2f,  -0x1.d906bcp-2f, 0x1.87de2ap-3f,        \
   0x1.8f8b84p-4f,  -0x1.1c73b4p-2f, 0x1.a9b662p-2f,  -0x1.f6297cp-2f,       \
   0x1.f6297cp-2f,  -0x1.a9b662p-2f, 0x1.1c73b4p-2f,  -0x1.8f8b84p-4f}

// C[k]; k must be a compile-time constant after unrolling.
__device__ __forceinline__ float dct(int k) {
  const float c[64] = BLOCK8X8_DCT_MATRIX;
  return c[k];
}

// The quantization tables of the kCh channels (Y, Cb, Cr; or the one
// plane's), row-major: a by-value kernel argument.
template <int kCh>
struct Tables {
  float Q[kCh][64];
};

// A (N, kCh, H, W) batch as strips: a tile has `rows` block rows of `cols`
// strips each (the last strip of a block row may hold 8, 16 or 24 columns).
struct Geometry {
  int W;           // columns of a tile
  int plane;       // H * W: samples of one channel of one tile
  unsigned tiles;  // N
  unsigned rows;   // H / 8
  unsigned cols;   // ceil(W / 32)
};

// A tile's width and channel plane: compile-time for kTile > 0 (square
// kTile x kTile tiles), else the Geometry's.
template <int kTile>
struct Dims {
  int W, plane;
  __device__ __forceinline__ explicit Dims(const Geometry& g)
      : W(kTile ? kTile : g.W), plane(kTile ? kTile * kTile : g.plane) {}
};

// Strip `sc` of block row `br` of tile `n`.
struct Cursor {
  unsigned n, br, sc;
};

// One strip: the offset of its top-left sample in channel 0, and how many
// of its 32 columns lie inside the tile.
struct Strip {
  int64_t base;
  int width;
};

// A (warp's) channel-major transpose buffer: [channel][row][column].
template <int kCh>
using Buffer = float[kCh][8][kPitch];

__device__ __forceinline__ Cursor split(unsigned s, const Geometry& g) {
  const unsigned per_tile = g.rows * g.cols;
  const unsigned n = s / per_tile, r = s - n * per_tile;
  const unsigned br = r / g.cols;
  return {n, br, r - br * g.cols};
}

// c += d, digit by digit: each of c's and d's digits is below its radix,
// so one carry at most per digit.
__device__ __forceinline__ void advance(Cursor& c, const Cursor& d,
                                        const Geometry& g) {
  c.sc += d.sc;
  unsigned carry = c.sc >= g.cols;
  if (carry) c.sc -= g.cols;
  c.br += d.br + carry;
  carry = c.br >= g.rows;
  if (carry) c.br -= g.rows;
  c.n += d.n + carry;
}

template <int kTile, int kCh>
__device__ __forceinline__ Strip strip_at(const Cursor& c,
                                          const Geometry& g) {
  const Dims<kTile> d(g);
  const int col0 = (int)c.sc * kStripW;
  // a kTile that is a multiple of 32 never masks: known at compile time
  const int width =
      kTile && kTile % kStripW == 0 ? kStripW : d.W - col0;
  return {(int64_t)c.n * kCh * d.plane + (int)c.br * 8 * d.W + col0,
          width < kStripW ? width : kStripW};
}

// Lane `lane`'s 8 kCh samples of strip `s`: x[ch][j] = row j of column
// lane in channel ch; zeros for a column past the tile's edge.
template <int kTile, int kCh, typename T>
__device__ __forceinline__ void load(const T* __restrict__ in,
                                     const Geometry& g, const Strip& s,
                                     int lane, T (&x)[kCh][8]) {
  const Dims<kTile> d(g);
  const T* p = in + s.base + lane;  // 64-bit once; 32-bit offsets below
  const bool live = lane < s.width;
#pragma unroll
  for (int ch = 0; ch < kCh; ++ch)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      x[ch][j] = live ? __ldcs(p + (ch * d.plane + j * d.W)) : T(0);
}

// Before: lane l holds pass 1's results for column l, t[ch][i] for the
// strip's rows i = 0..7. After: lane 8b + i holds row i of block b,
// t[ch][k] for the block's columns k = 0..7. The pitch of 33 makes both
// the writes and the reads conflict-free.
template <int kCh>
__device__ __forceinline__ void transpose(Buffer<kCh>& buf,
                                          float (&t)[kCh][8], int lane) {
#pragma unroll
  for (int ch = 0; ch < kCh; ++ch)
#pragma unroll
    for (int i = 0; i < 8; ++i) buf[ch][i][lane] = t[ch][i];
  __syncwarp();
  const int i = lane & 7, c0 = lane & ~7;
#pragma unroll
  for (int ch = 0; ch < kCh; ++ch)
#pragma unroll
    for (int k = 0; k < 8; ++k) t[ch][k] = buf[ch][i][c0 + k];
  __syncwarp();  // the next strip's writes wait for these reads
}

// Warp w of the grid takes strips w, w + S, w + 2S, ... (S: the grid's
// warps, kCtaWarps a CTA) and calls body(strip, samples) on each. With
// kAhead = 1 the next strip's loads are issued before the current strip's
// body runs (a register double buffer, 8 kCh more registers a lane); with
// kAhead = 0 a strip's loads wait for the previous strip's body, and the
// other warps on the SM hide their latency.
template <int kTile, int kAhead, int kCh, int kCtaWarps = kWarps,
          typename T, typename Body>
__device__ __forceinline__ void walk(const T* __restrict__ in,
                                     const Geometry& g, Body&& body) {
  static_assert(kAhead == 0 || kAhead == 1, "one strip ahead at most");
  const int lane = threadIdx.x & 31;
  Cursor c = split(blockIdx.x * kCtaWarps + threadIdx.x / 32, g);
  const Cursor step = split(gridDim.x * kCtaWarps, g);
  if (kAhead == 0) {
    T a[kCh][8];
    for (; c.n < g.tiles; advance(c, step, g)) {
      const Strip s = strip_at<kTile, kCh>(c, g);
      load<kTile>(in, g, s, lane, a);
      body(s, a);
    }
    return;
  }
  if (c.n >= g.tiles) return;
  T a[kCh][8], b[kCh][8];
  Strip sa = strip_at<kTile, kCh>(c, g), sb;
  load<kTile>(in, g, sa, lane, a);
  advance(c, step, g);
  for (;;) {  // warp-uniform: every lane takes the same strips
    bool more = c.n < g.tiles;
    if (more) {
      sb = strip_at<kTile, kCh>(c, g);
      load<kTile>(in, g, sb, lane, b);
      advance(c, step, g);
    }
    body(sa, a);
    if (!more) return;
    more = c.n < g.tiles;
    if (more) {
      sa = strip_at<kTile, kCh>(c, g);
      load<kTile>(in, g, sa, lane, a);
      advance(c, step, g);
    }
    body(sb, b);
    if (!more) return;
  }
}

// Whether the launch can run: H, W positive multiples of 8, a tile's kCh
// channels addressable in 32 bits, the strip count and the walk's cursor
// inside 31 bits, and the output on a 16-byte boundary (the stores write
// 8- and 16-byte pieces; the input is read one 4-byte sample a lane, so it
// needs only its type's alignment). Fills g.
template <int kCh>
inline bool make_geometry(const void* out, int64_t N, int64_t H, int64_t W,
                          Geometry* g) {
  if (N <= 0 || H <= 0 || W <= 0 || H % 8 || W % 8) return false;
  if (kCh * H * W >= (int64_t(1) << 31)) return false;
  const int64_t cols = (W + kStripW - 1) / kStripW;
  if (N * (H / 8) * cols >= (int64_t(1) << 31)) return false;
  if ((uintptr_t)out % 16) return false;
  *g = {(int)W, (int)(H * W), (unsigned)N, (unsigned)(H / 8),
        (unsigned)cols};
  return true;
}

template <int kCh>
inline Tables<kCh> make_tables(const float* q_host) {
  Tables<kCh> t;
  memcpy(t.Q, q_host, sizeof t.Q);
  return t;
}

// The persistent grid of `kernel`, CTAs of kCtaWarps warps: as many as fit
// on the card at once (its occupancy times the SM count, found once per
// device), but no more than the strips need.
template <auto kernel, int kCtaWarps = kWarps>
inline cudaError_t persistent_grid(const Geometry& g, unsigned* grid) {
  static int resident[64];  // CTAs the card holds at once, per device
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!resident[dev]) {
    int sms, per_sm;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, 32 * kCtaWarps, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    resident[dev] = sms * per_sm;
  }
  const int64_t strips = (int64_t)g.tiles * g.rows * g.cols;
  const int64_t need = (strips + kCtaWarps - 1) / kCtaWarps;
  *grid = (unsigned)(need < resident[dev] ? need : resident[dev]);
  return cudaSuccess;
}

}  // namespace block8x8
