// Baseline JPEG Huffman decode of N independent tile scans (4:4:4), written
// straight into the (N, 3, H, W) coefficient planes the inverse transform
// reads.
//
// Replaces: src/repro/wsi/entropy_jax.py, _lockstep / decode_scans (the
// TPU's device program: a jitted lax.while_loop that advances every tile one
// symbol per step in lockstep, writes zigzag coefficients, and leaves the DC
// integration and the inverse-zigzag scatter to the host).
//
// Bound on this card: bytes. The coefficients are written once (3.22 GB at
// level 0 of a 16384^2 slide) and the scans read once: 0.967 ms at 3.35
// TB/s. A scan without restart markers is one chain of dependent symbols
// (each one's bit position depends on every earlier code length), so a
// decoder that walks it alone takes the longest tile's symbol count times
// one symbol's latency (10.3 ms at level 0 with one thread per tile); this
// design cuts the chain. PERF.md section 6 splits its time at level 0 on
// an H100 into the sync rounds and the scan, the write pass's decoding and
// the block-row stores (16-byte stores, each lane's to another line).
//
// Design: one CTA of kThreads threads per tile. Each thread owns a range of
// the scan's bits (ranges of L bits, L a multiple of 32; the last range runs
// on past the scan's end to the first symbol that ends beyond it). A
// decoder's state at a symbol boundary is (bit, component, zigzag slot), and
// the state alone fixes how the next bits parse. Huffman codes are
// self-synchronising in practice: a decoder started at a wrong boundary
// soon falls onto the true ones, and from a common state two decoders
// decode the same symbols.
//   1. sync rounds: thread j guesses its entry state (j*L, 0, 0), decodes to
//      the first boundary at or past its range's end and hands that state
//      to thread j+1 as its entry; a thread whose entry changed decodes
//      again, until no entry changes (one block-wide vote a round). Entry 0
//      is true, so after round r entries 0..r+1 are, and the result does not
//      depend on how fast the decoders synchronise, only the time does. A
//      decode that meets an invalid code or a run past the block hands
//      nothing on;
//   2. the last decode of each range counted its symbols, completed units,
//      DC symbols, DC differences per component and its first failure;
//   3. a block-wide exclusive scan gives each range its first global symbol
//      index, first unit and DC predictors; the first range in which the
//      tile ends (a failure below the last unit, or the last unit's
//      completion) fixes the lane's stop, error kind and the units started;
//   4. dense write: each thread owns the units whose DC symbol lies in its
//      range, decodes them again (the last one past its range's end), builds
//      each in a 64-entry int32 buffer in shared memory (XOR-swizzled by
//      16-byte chunk against bank conflicts) and writes its 8x8 block once,
//      as eight 32-byte rows. Units from the lane's failure on are written
//      as zero blocks, so every coefficient is written once and the wrapper
//      allocates the output with torch.empty.
// Per symbol: a 64-bit bit buffer refilled a 32-bit big-endian word at a
// time (__ldg; a word that is not wholly inside buf is read bytewise, so no
// load leaves buf); an 11-bit first-level table in shared memory (4 x 2,048
// int16; faster than 10 bits on an H100, PERF.md section 6), falling to the
// 16-bit table in global memory (4 x 65,536 int16) for longer codes; int32
// bit cursors relative to each scan, an int64 base offset; no 64-bit
// division.
//
// Errors: a lane stops at its first failure. Every lane records the index
// of the symbol at which it stopped (its last symbol, or the failing one)
// and the kind of failure (0 none, 1 invalid code, 2 AC run past the
// block, 3 truncation). In the lockstep reference, step s is every live
// lane's s-th symbol and the first failing step raises with priority
// invalid > run > truncation, so the host reproduces its error exactly: the
// minimum index over failed lanes, then the lowest kind among them there.
//
// Exactness: integer only. The plain version (ref.py, entropy_decode_ref,
// the lockstep) matches it value for value, errors included;
// entropy_decode_subseq_ref mirrors this design step by step, rounds
// included.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // threads (ranges) per tile; ops.py's
                               // ENTROPY_THREADS
constexpr int kWarps = kThreads / 32;
constexpr int kFastBits = 11;  // first-level table width
constexpr int kInvalid = 1, kRun = 2, kTrunc = 3;
// dynamic shared memory: the unit buffers, then the first-level tables
constexpr int kUnitBytes = kThreads * 64 * 4;
constexpr int kSmemBytes = kUnitBytes + 4 * (1 << kFastBits) * 2;

struct Zigzag {
  int8_t nat[64];  // zigzag slot -> row-major position in the 8x8 block
};

// A scan's bits, next bit at the top of acc.
struct Bits {
  const uint8_t* lo;    // buf
  const uint8_t* hi;    // buf's end
  const uint8_t* next;  // the next 4-aligned word to load
  uint64_t acc;
  int have;  // valid bits in acc

  __device__ __forceinline__ uint32_t word(const uint8_t* p) const {
    if (p >= lo && p + 4 <= hi)
      return __byte_perm(__ldg(reinterpret_cast<const uint32_t*>(p)), 0,
                         0x0123);
    uint32_t w = 0;  // a word at buf's edge: its bytes inside buf only
    for (int i = 0; i < 4; ++i)
      if (p + i >= lo && p + i < hi)
        w |= (uint32_t)__ldg(p + i) << (24 - 8 * i);
    return w;
  }
  // position at bit pos of the scan that starts at byte scan
  __device__ __forceinline__ void seek(const uint8_t* scan, int pos) {
    const uint8_t* b = scan + (pos >> 3);
    const uint8_t* a =
        reinterpret_cast<const uint8_t*>((uintptr_t)b & ~(uintptr_t)3);
    const int skip = (int)(b - a) * 8 + (pos & 7);
    acc = (((uint64_t)word(a) << 32) | word(a + 4)) << skip;
    have = 64 - skip;
    next = a + 8;
  }
  __device__ __forceinline__ void refill() {  // keeps have >= 33
    if (have <= 32) {
      acc |= (uint64_t)word(next) << (32 - have);
      have += 32;
      next += 4;
    }
  }
};

struct Tables {
  const int16_t* fast;  // shared: 4 x 2^kFastBits, 0 = not decided here
  const int16_t* __restrict__ lut;  // global: 4 x 65,536
};

// One symbol at state (comp, k): 0, or the failure's kind (nothing
// consumed). On success pos and the bits advance, k is the next slot (0
// when the unit is done), v the value, slot the zigzag slot written (-1:
// none), dc whether it was a DC symbol, adv whether it completed its unit.
__device__ __forceinline__ int decode_symbol(Bits& br, const Tables& t,
                                             int comp, int& k, int& pos,
                                             int& v, int& slot, bool& dc,
                                             bool& adv, int& slow) {
  br.refill();
  dc = k == 0;
  const int tbl = (dc ? 0 : 2) + (comp != 0);
  int e = t.fast[(tbl << kFastBits) | (int)(br.acc >> (64 - kFastBits))];
  if (e == 0) {
    e = __ldg(t.lut + (tbl << 16) + (int)(br.acc >> 48));
    ++slow;
  }
  const int sym = e & 0xFF, ln = e >> 8;
  if (ln == 0) return kInvalid;
  const int s = dc ? sym : (sym & 15);
  v = 0;
  if (s) {
    const int bits = (int)((br.acc << ln) >> (64 - s));
    v = bits >= (1 << (s - 1)) ? bits : bits - ((1 << s) - 1);
  }
  slot = -1;
  if (dc) {
    slot = 0;
    k = 1;
  } else if (sym == 0x00) {  // EOB: the rest of the block stays zero
    k = 64;
  } else if (sym == 0xF0) {  // ZRL: sixteen zeros
    k += 16;
  } else {
    const int knew = k + (sym >> 4);
    if (knew > 63) return kRun;
    slot = knew;
    k = knew + 1;
  }
  adv = k >= 64;
  if (adv) k = 0;
  br.acc <<= ln + s;
  br.have -= ln + s;
  pos += ln + s;
  return 0;
}

// What one decode of a range counted.
struct Counts {
  int nsym, units, ndc;
  uint32_t dc0, dc1, dc2;  // DC differences per component (int32 wrap)
  int f_i, f_a, f_k, f_kind;  // first failure: local symbol, units, slot
};

// Decode from state (pos, comp, k) to the first boundary at or past end.
// Returns whether the state there is handed on (no invalid code or run).
__device__ __forceinline__ bool decode_range(
    const uint8_t* scan, const Bits& edges, const Tables& t, int nbits,
    int end, int& pos, int& comp, int& k, Counts& c, int& ndec, int& slow) {
  c = Counts{};
  if (pos >= end) return true;
  Bits br = edges;
  br.seek(scan, pos);
  while (pos < end) {
    int kk = k, v, slot;
    bool dc, adv;
    const int kind = decode_symbol(br, t, comp, kk, pos, v, slot, dc, adv,
                                   slow);
    ++ndec;
    if (kind) {
      c.f_i = c.nsym;
      c.f_a = c.units;
      c.f_k = k;
      c.f_kind = kind;
      return false;
    }
    if (dc) {
      ++c.ndc;
      c.dc0 += comp == 0 ? (uint32_t)v : 0u;
      c.dc1 += comp == 1 ? (uint32_t)v : 0u;
      c.dc2 += comp == 2 ? (uint32_t)v : 0u;
    }
    ++c.nsym;
    k = kk;
    if (adv) {
      ++c.units;
      comp = comp == 2 ? 0 : comp + 1;
    }
    if (pos > nbits) {  // the symbol ends past the scan: the last decoded
      c.f_i = c.nsym - 1;
      c.f_a = c.units;
      c.f_k = k;
      c.f_kind = kTrunc;
    }
  }
  return true;
}

// Exclusive scan of x over the CTA's threads (all threads call it).
__device__ __forceinline__ uint32_t exclusive_scan(uint32_t x,
                                                   uint32_t* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  uint32_t before = 0;
  for (int w = 0; w < warp; ++w) before += warp_sums[w];
  __syncthreads();  // warp_sums is reused by the next scan
  return before + inc - x;
}

__device__ __forceinline__ int chunk_index(int z, int sw) {
  return (((z >> 2) ^ sw) << 2) | (z & 3);
}

__global__ void __launch_bounds__(kThreads)
entropy_decode_kernel(const uint8_t* __restrict__ buf, int64_t buf_len,
                      const int64_t* __restrict__ offs,
                      const int32_t* __restrict__ nbits_of,
                      const int16_t* __restrict__ lut,
                      int32_t* __restrict__ out, int32_t* __restrict__ stop,
                      int32_t* __restrict__ err_kind,
                      int32_t* __restrict__ stats, int H, int W, Zigzag zz) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* unit_bufs = reinterpret_cast<int32_t*>(smem);
  int16_t* fast = reinterpret_cast<int16_t*>(smem + kUnitBytes);
  __shared__ int e_pos[kThreads], e_ck[kThreads];  // entry states
  __shared__ unsigned char redo[kThreads];
  __shared__ int8_t nat[64];
  __shared__ uint32_t warp_sums[kWarps];
  __shared__ int s_jend, s_failed, s_stop, s_kind, s_uz, s_limit,
      s_clean_stop;

  const int tid = threadIdx.x, n = blockIdx.x;
  for (int i = tid; i < 4 << kFastBits; i += kThreads) {
    const int e = lut[((i >> kFastBits) << 16) +
                      ((i & ((1 << kFastBits) - 1)) << (16 - kFastBits))];
    const int ln = e >> 8;
    fast[i] = (int16_t)(ln >= 1 && ln <= kFastBits ? e : 0);
  }
  if (tid < 64) nat[tid] = zz.nat[tid];
  if (tid == 0) s_jend = kThreads;

  const uint8_t* scan = buf + offs[n];
  const int nb = nbits_of[n];
  const int nu = (H >> 3) * (W >> 3) * 3;
  const int L = 32 * max(1, (int)(((int64_t)nb + 32 * kThreads - 1) /
                                  (32 * kThreads)));
  const int J = max(1, (int)(((int64_t)nb + L - 1) / L));
  const bool lane = tid < J;
  const int end = tid == J - 1 ? nb + 1 : (tid + 1) * L;
  if (lane) {
    e_pos[tid] = tid * L;
    e_ck[tid] = 0;
  }
  Bits edges;
  edges.lo = buf;
  edges.hi = buf + buf_len;
  const Tables t{fast, lut};
  __syncthreads();

  // 1-2. sync rounds; each thread keeps the counts of its last decode
  Counts c{};
  bool todo = lane, handed = false;
  int x_pos = 0, x_comp = 0, x_k = 0, rounds = 0, ndec = 0, slow = 0;
  for (;;) {
    if (todo) {
      x_pos = e_pos[tid];
      x_comp = e_ck[tid] >> 8;
      x_k = e_ck[tid] & 0xFF;
      handed = decode_range(scan, edges, t, nb, end, x_pos, x_comp, x_k, c,
                            ndec, slow);
    }
    ++rounds;
    __syncthreads();  // every entry is read
    bool changed = false;
    if (todo && handed && tid + 1 < J) {
      const int ck = x_comp << 8 | x_k;
      if (x_pos != e_pos[tid + 1] || ck != e_ck[tid + 1]) {
        e_pos[tid + 1] = x_pos;
        e_ck[tid + 1] = ck;
        changed = true;
      }
    }
    if (tid + 1 < kThreads) redo[tid + 1] = changed;
    if (!__syncthreads_or(changed)) break;
    todo = tid > 0 && redo[tid];
  }

  // 3. the scan over the ranges, and the tile's outcome
  if (!lane) c = Counts{};
  const int s0 = (int)exclusive_scan((uint32_t)c.nsym, warp_sums);
  const int u0 = (int)exclusive_scan((uint32_t)c.units, warp_sums);
  uint32_t p0 = exclusive_scan(c.dc0, warp_sums);
  uint32_t p1 = exclusive_scan(c.dc1, warp_sums);
  uint32_t p2 = exclusive_scan(c.dc2, warp_sums);
  const bool fail_end = lane && c.f_kind && u0 + c.f_a < nu;
  if (fail_end || (lane && u0 + c.units >= nu)) atomicMin(&s_jend, tid);
  __syncthreads();
  const int jend = s_jend;
  if (tid == jend) {
    s_failed = fail_end;
    s_stop = fail_end ? s0 + c.f_i : -1;
    s_kind = fail_end ? c.f_kind : 0;
    s_uz = fail_end ? u0 + c.f_a + (c.f_k != 0) : nu;
    s_limit = fail_end ? s0 + c.f_i + (c.f_kind == kTrunc) : 0x7fffffff;
    s_clean_stop = -1;
  } else if (tid == 0 && jend == kThreads) {
    // unreachable (the range holding the true decode's end always ends
    // it); kept so that no thread reads an unset outcome
    s_failed = 1;
    s_stop = s0;
    s_kind = kTrunc;
    s_uz = 0;
    s_limit = 0;
  }
  __syncthreads();
  const int uz = s_uz, limit = s_limit;

  // 4. dense write of the units this thread owns
  const int sw = tid & 7;
  int32_t* ub = unit_bufs + tid * 64;
  const int64_t plane = (int64_t)H * W;
  int32_t* tile = out + (int64_t)n * 3 * plane;
  const int bw = W >> 3;
  const int first = u0 + ((e_ck[tid] & 0xFF) != 0);
  const int n_own = lane && tid <= jend ? max(0, min(c.ndc, uz - first)) : 0;
  if (n_own > 0) {
    const int4 z4 = make_int4(0, 0, 0, 0);
    for (int i = 0; i < 16; ++i) reinterpret_cast<int4*>(ub)[i] = z4;
    int pos = e_pos[tid], comp = e_ck[tid] >> 8, k = e_ck[tid] & 0xFF;
    int g = s0, unit = first, done = 0;
    int blk = unit / 3;
    int by = blk / bw, bx = blk - by * bw;
    bool skip = k != 0;  // the symbols that finish the previous owner's unit
    Bits br = edges;
    br.seek(scan, pos);
    for (;;) {
      bool write = g >= limit;  // a failing unit, as far as it went
      if (!write) {
        int v, slot;
        bool dc, adv;
        if (decode_symbol(br, t, comp, k, pos, v, slot, dc, adv, slow))
          break;  // unreachable: no symbol before the limit fails
        ++ndec;
        if (!skip && slot >= 0) {
          if (dc) {
            if (comp == 0) v = (int)(p0 += (uint32_t)v);
            else if (comp == 1) v = (int)(p1 += (uint32_t)v);
            else v = (int)(p2 += (uint32_t)v);
          }
          ub[chunk_index(nat[slot], sw)] = v;
        }
        ++g;
        if (adv) {
          comp = comp == 2 ? 0 : comp + 1;
          if (skip) {
            skip = false;
          } else {
            write = true;
            if (unit == nu - 1) s_clean_stop = g - 1;
          }
        }
      }
      if (write) {
        const int ucomp = unit - blk * 3;
        int32_t* dst = tile + ucomp * plane + (int64_t)by * 8 * W + bx * 8;
        const int4* src = reinterpret_cast<const int4*>(ub);
        for (int r = 0; r < 8; ++r) {  // streaming stores: never read here
          int4* row = reinterpret_cast<int4*>(dst + (int64_t)r * W);
          __stcs(row, src[(2 * r) ^ sw]);
          __stcs(row + 1, src[(2 * r + 1) ^ sw]);
        }
        if (g >= limit || ++done == n_own) break;
        for (int i = 0; i < 16; ++i) reinterpret_cast<int4*>(ub)[i] = z4;
        if (++unit - blk * 3 == 3) {
          ++blk;
          if (++bx == bw) {
            bx = 0;
            ++by;
          }
        }
      }
    }
  }
  // zero blocks for the units from the lane's failure on: one 32-byte row
  // a thread
  for (int i = uz * 8 + tid; i < nu * 8; i += kThreads) {
    const int unit = i >> 3, r = i & 7, b = unit / 3;
    const int by = b / bw;
    int4* row = reinterpret_cast<int4*>(tile + (unit - b * 3) * plane +
                                        ((int64_t)by * 8 + r) * W +
                                        (b - by * bw) * 8);
    __stcs(row, make_int4(0, 0, 0, 0));
    __stcs(row + 1, make_int4(0, 0, 0, 0));
  }
  __syncthreads();
  if (tid == 0) {
    stop[n] = s_failed ? s_stop : s_clean_stop;
    err_kind[n] = s_kind;
  }
  if (stats) {  // the debug output: rounds, symbols decoded, slow lookups
    if (tid == 0) stats[3 * n] = rounds;
    atomicAdd(stats + 3 * n + 1, ndec);
    atomicAdd(stats + 3 * n + 2, slow);
  }
}

}  // namespace

// buf: (buf_len,) uint8, every tile's unstuffed scan, each followed by >= 8
// zero bytes inside buf; offs: (N,) int64 byte offset of each scan; nbits:
// (N,) int32 scan length in bits; lut: (4 * 65536,) int16 tables; out: (N,
// 3, H, W) int32, every coefficient written here; stop, err_kind: (N,)
// int32; stats: null, or (N, 3) int32 zeroed by the caller (per tile: sync
// rounds, symbols decoded over all passes, lookups that fell through to
// the 16-bit table). All on the device. zz_host: the 64 zigzag positions
// (on the host: a kernel argument). H and W must be multiples of 8.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int entropy_decode_launch(const uint8_t* buf, int64_t buf_len,
                                     const int64_t* offs,
                                     const int32_t* nbits, const int16_t* lut,
                                     int32_t* out, int32_t* stop,
                                     int32_t* err_kind, int32_t* stats,
                                     int64_t N, int64_t H, int64_t W,
                                     const int64_t* zz_host, void* stream) {
  if (N == 0) return 0;
  if (H <= 0 || W <= 0 || H % 8 || W % 8 || N > 0x7fffffff ||
      (H / 8) * (W / 8) * 3 > 0x7fffffff / 8)
    return (int)cudaErrorInvalidValue;
  Zigzag zz;
  for (int i = 0; i < 64; ++i) zz.nat[i] = (int8_t)zz_host[i];
  cudaError_t err = cudaFuncSetAttribute(
      entropy_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  entropy_decode_kernel<<<(unsigned)N, kThreads, kSmemBytes,
                          (cudaStream_t)stream>>>(
      buf, buf_len, offs, nbits, lut, out, stop, err_kind, stats, (int)H,
      (int)W, zz);
  return (int)cudaGetLastError();
}
