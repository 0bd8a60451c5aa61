// Baseline JPEG Huffman decode of N independent tile scans (4:4:4), written
// straight into the (N, 3, H, W) coefficient planes the inverse transform
// reads.
//
// Replaces: src/repro/wsi/entropy_jax.py, _lockstep / decode_scans (the
// TPU's device program: a jitted lax.while_loop that advances every tile one
// symbol per step in lockstep, writes zigzag coefficients, and leaves the DC
// integration and the inverse-zigzag scatter to the host).
//
// Bound on this card: latency, not bytes or operations. Each symbol needs
// the one before it (its bit position depends on every earlier code
// length), so a tile is a chain of dependent table reads; the level takes
// as long as its longest scan. The bytes bound -- the coefficients written
// once (3.22 GB at level 0 of a 16384^2 slide) plus the scan bytes read --
// is ~1 ms; the kernel's time is set by the longest lane's symbol count
// times one symbol's latency (a table read that hits L2 plus ~30 integer
// operations).
//
// Design: one thread decodes one tile's whole scan alone -- the lockstep
// across tiles was the TPU's device, and a thread needs none. Blocks of 32
// threads, so a level of 4096 tiles spreads one warp over each SM. Each
// thread:
//   - keeps a 64-bit bit buffer refilled byte by byte (one refill per
//     symbol: a code of <= 16 bits plus <= 11 magnitude bits always fit), an
//     int64 base offset into the packed buffer and an int32 bit cursor
//     relative to its own scan, so no batch size is too large;
//   - looks up each symbol in the 16-bit lookahead tables (4 x 65,536 int16
//     entries, symbol | code length << 8: 512 KB, read through L2);
//   - integrates its DC predictors and scatters every value through the
//     inverse zigzag into its tile's blocks, so the output is what the
//     inverse transform consumes, with no host round trip. Coefficients it
//     never writes stay as the wrapper's zero fill.
// Errors: a lane stops at its first failure. Every lane records the index
// of the symbol at which it stopped (its last symbol, or the failing one)
// and the kind of failure (0 none, 1 invalid code, 2 AC run past the
// block, 3 truncation). In the lockstep reference, step s is every live
// lane's s-th symbol and the first failing step raises with priority
// invalid > run > truncation, so the host reproduces its error exactly: the
// minimum index over failed lanes, then the lowest kind among them there.
//
// Exactness: integer only; the plain version (ref.py, entropy_decode_ref)
// runs the same automaton lane-parallel and matches it value for value,
// errors included.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;  // threads (tiles) per CTA
constexpr int kInvalid = 1, kRun = 2, kTrunc = 3;

struct Zigzag {
  int8_t nat[64];  // zigzag slot -> row-major position in the 8x8 block
};

__global__ void __launch_bounds__(kLanes)
entropy_decode_kernel(const uint8_t* __restrict__ buf,
                      const int64_t* __restrict__ offs,
                      const int32_t* __restrict__ nbits,
                      const int16_t* __restrict__ lut,
                      int32_t* __restrict__ out,
                      int32_t* __restrict__ stop,
                      int32_t* __restrict__ err_kind, int64_t N, int64_t H,
                      int64_t W, Zigzag zz) {
  __shared__ int8_t nat[64];
  for (int i = threadIdx.x; i < 64; i += blockDim.x) nat[i] = zz.nat[i];
  __syncthreads();
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;

  const uint8_t* p = buf + offs[n];
  const int32_t end = nbits[n];
  const int64_t plane = H * W;
  const int64_t bw = W / 8;
  const int64_t nu = (H / 8) * bw * 3;
  int32_t* tile = out + n * 3 * plane;

  uint64_t acc = 0;  // bit buffer, next bit at the top
  int have = 0;      // valid bits in acc
  int64_t next = 0;  // next byte of the scan to load
  int32_t pos = 0;   // bits consumed
  int32_t pred0 = 0, pred1 = 0, pred2 = 0;
  int64_t u = 0, blk = 0;
  int comp = 0, k = 0;  // k: next zigzag slot, 0 = the DC symbol is next
  int64_t unit = 0;     // this unit's plane offset of its block's (0, 0)
  int32_t step = 0;
  int kind = 0;

  for (; u < nu; ++step) {
    while (have <= 56) {
      acc |= (uint64_t)p[next++] << (56 - have);
      have += 8;
    }
    const bool dc = k == 0;
    const int tbl = (dc ? 0 : 2) + (comp != 0);
    const int e = lut[tbl * 65536 + (int)(acc >> 48)];
    const int sym = e & 0xFF, ln = e >> 8;
    if (ln == 0) {
      kind = kInvalid;
      break;
    }
    const int s = dc ? sym : (sym & 15);
    int32_t v = 0;
    if (s) {
      const int32_t bits = (int32_t)((acc << ln) >> (64 - s));
      v = bits >= (1 << (s - 1)) ? bits : bits - ((1 << s) - 1);
    }
    int slot = -1;
    if (dc) {
      if (comp == 0) v = pred0 += v;
      else if (comp == 1) v = pred1 += v;
      else v = pred2 += v;
      slot = 0;
      k = 1;
    } else if (sym == 0x00) {  // EOB: the rest of the block stays zero
      k = 64;
    } else if (sym == 0xF0) {  // ZRL: sixteen zeros
      k += 16;
    } else {
      const int knew = k + (sym >> 4);
      if (knew > 63) {
        kind = kRun;
        break;
      }
      slot = knew;
      k = knew + 1;
    }
    acc <<= ln + s;
    have -= ln + s;
    pos += ln + s;
    if (slot >= 0) {
      const int z = nat[slot];
      tile[unit + (z >> 3) * W + (z & 7)] = v;
    }
    if (k >= 64) {  // next unit: component, then block
      k = 0;
      ++u;
      if (++comp == 3) {
        comp = 0;
        ++blk;
      }
      unit = comp * plane + (blk / bw) * 8 * W + (blk % bw) * 8;
    }
    if (u < nu && pos > end) {
      kind = kTrunc;
      break;
    }
  }
  stop[n] = kind ? step : step - 1;
  err_kind[n] = kind;
}

}  // namespace

// buf: every tile's unstuffed scan, each followed by >= 8 zero bytes;
// offs: (N,) int64 byte offset of each scan; nbits: (N,) int32 scan length
// in bits; lut: (4 * 65536,) int16 tables; out: (N, 3, H, W) int32, zeroed
// by the caller; stop, err_kind: (N,) int32. All on the device.
// zz_host: the 64 zigzag positions (on the host: a kernel argument).
// H and W must be multiples of 8.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int entropy_decode_launch(const uint8_t* buf, const int64_t* offs,
                                     const int32_t* nbits, const int16_t* lut,
                                     int32_t* out, int32_t* stop,
                                     int32_t* err_kind, int64_t N, int64_t H,
                                     int64_t W, const int64_t* zz_host,
                                     void* stream) {
  if (N == 0) return 0;
  if (H <= 0 || W <= 0 || H % 8 || W % 8) return (int)cudaErrorInvalidValue;
  Zigzag zz;
  for (int i = 0; i < 64; ++i) zz.nat[i] = (int8_t)zz_host[i];
  const int64_t blocks = (N + kLanes - 1) / kLanes;
  entropy_decode_kernel<<<(unsigned)blocks, kLanes, 0,
                          (cudaStream_t)stream>>>(
      buf, offs, nbits, lut, out, stop, err_kind, N, H, W, zz);
  return (int)cudaGetLastError();
}
