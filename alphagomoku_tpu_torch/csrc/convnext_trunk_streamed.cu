// The streamed entry of the fused ConvNext trunk: trunks wider than 256
// filters (the width padded with zero channels to a multiple of 64), on
// boards of any size.  Replaces the Pallas TPU kernel `_trunk_kernel` of
// alphagomoku_tpu/ops/convnext_fused.py (wrapper `fused_trunk`) at those
// widths, with the same function and rounding points as the entries of
// convnext_trunk.cu: per block a depthwise 7x7 (f32 taps, f32 sums in the
// plain version's order), folded BatchNorm to bf16, relu(ym @ w1 + b1) to
// bf16, bf16(ym2 @ w2 + b2) plus the residual to bf16, the squeeze-
// excitation gate from the f32 cell mean (z, h1 and the gate each to bf16)
// and the channel scale to bf16.
//
// Why a sequence of kernels.  The Pallas kernel keeps a board's whole
// activation and a block's weights in VMEM, megabytes of it.  A CTA on the
// H100 has 232,448 B of shared memory.  convnext_trunk.cu's wide entry
// splits a board's rows over a cluster, but at C = 384 on 20x20 a CTA of
// an 8-CTA cluster would need 302,080 B, and at C = 512 its taps, vectors
// and weight stages alone take 151,552 B.  So here each block runs as four
// launches, and the activations stay in device memory between them (in L2
// at B = 32 to 64; in HBM at B = 1280, where one activation is 221 MB at
// C = 384 on 15x15):
//   a) streamed_depthwise: one CTA per (64-channel slice, board; a board
//      above 20x20 in tiles of at most 20 x 20).  The slice's board and its
//      halo (zeros off the board), taps (f32), BN vectors and the previous
//      block's SE gate sit in shared memory (99,840 B at 20x20), a lane a
//      channel pair, a warp 128 bytes of a cell.  From the second block on
//      it gates on load, x = bf16(x4 * g), and writes that x for the
//      block's residual.
//   b) streamed_product<false>: y1 = bf16(relu(ym @ w1 + b1)), a tiled
//      product over the M = B H W cells: CTA tiles of 128 x 64, k stages of
//      32 double-buffered by cp.async, ldmatrix and mma.sync m16n8k16 (bf16
//      in, f32 sums), 8 warps of 32 x 32, two CTAs an SM.
//   c) streamed_product<true>: x4 = bf16(bf16(y1 @ w2 + b2) + x), the two
//      roundings of the plain version.
//   d) streamed_se: a CTA of 1024 threads per board, the f32 cell means of
//      x4 in a fixed order (no atomics: the same inputs give the same bits
//      on every run), z, h1 and the gate g, sw1 and sw2 read from L2.
// After the last block streamed_scale writes bf16(x4 * g).  A call is 4 L
// + 1 launches.  The wrapper (ops/convnext_fused.py `fused_trunk`)
// allocates the scratch tensors; nothing here allocates.
//
// The products settle their doubtful roundings in the plain version's sum
// order, as convnext_trunk.cu's settle() and settle_cta() do (see there
// why: without it each turned bf16 rounding spreads through the later
// blocks): an output whose value after + bias (and relu) rounds to another
// bf16 at the ends of acc -/+ kErr |a| |w| is summed again k ascending
// (each product of two bf16 values exact in f32, then added, as the plain
// version's `_products` does) from the A row and the matrix column in
// global memory (L2).  A CTA lists its doubtful outputs (about 10 to 20 of
// a tile's 8,192 at C = 384) and re-sums them a thread each, all at once,
// each loading 32 terms at a time (`seq_dot`).
//
// What bounds it on the H100: operations, as for the other entries.  At
// B = 1280, C = 384, L = 8 on 15x15 the products are 1.36e12 FLOP (1.37 ms
// at 989 TFLOP/s on the tensor cores) and the depthwise 86.7 GFLOP of f32
// on CUDA cores (1.29 ms at 67 TFLOP/s); the trunk's input and output are
// 0.44 GB (0.13 ms).  This first design also moves about 2 GB a block
// between its kernels at that batch (0.6 ms a block at 3.35 TB/s): it
// trades those bytes for a layout with no limit on width or board.  Faster
// designs (wgmma and TMA; one fused kernel with the channels split over a
// cluster) are later work.
//
// Helpers are copies of convnext_trunk.cu's (cp_async16, ldmatrix_x4,
// mma_bf16, unpack8; the row norms and the doubtful test of settle()):
// that file stays as it is, so its kernels' SASS does not move.  A
// rounding point changed there is changed here too.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;
using bf2 = __nv_bfloat162;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kK = 7;              // depthwise kernel
constexpr int kR = kK / 2;
constexpr int kTaps = kK * kK;
constexpr int kSlice = 64;         // channels of a depthwise CTA (32 pairs, a lane each)
constexpr int kStrip = 8;          // output cells of a row a lane sums at once
constexpr int kTile = 20;          // rows and columns of a depthwise tile at most
constexpr int kBM = 128;           // product tile: cells
constexpr int kBN = 64;            // product tile: output channels
constexpr int kBK = 32;            // k rows of a stage
constexpr int kAS = kBK + 8;       // A stage row stride (bf16): ldmatrix rows in 8 bank groups
constexpr int kBS = kBN + 8;       // B stage row stride (bf16)
constexpr int kCS = kBN + 4;       // f32 tile row stride
constexpr int kStages = 2;         // k stages of a product in flight
constexpr int kSettleK = 32;       // k terms a re-sum loads at once
constexpr int kSeThreads = 1024;   // threads of a SE CTA (one board)
// settle()'s error scale, as in convnext_trunk.cu: u = 2^-24
constexpr float kErr = 5.9604645e-8f;

constexpr size_t kStageBytes =
    kStages * (size_t(kBM) * kAS + size_t(kBK) * kBS) * sizeof(bf16);
// after the k loop the f32 tile takes the stages' place
constexpr size_t kTileBytes = size_t(kBM) * kCS * sizeof(float);
constexpr size_t kUnionBytes = kStageBytes > kTileBytes ? kStageBytes : kTileBytes;

struct Weights {
  const bf16 *dw, *w1, *w2, *sw1, *sw2;
  const float *bn_s, *bn_t, *b1, *b2, *sb1, *sb2;
};

// The depthwise's tiles of an H x W board: the fewest tiles of at most
// kTile rows and kTile columns, of `rows` x `cols` cells (the last ones
// shorter), `col_tiles` of them across.
struct DwTiles {
  int rows, cols, row_tiles, col_tiles;
  static DwTiles of(int H, int W) {
    DwTiles t;
    t.row_tiles = (H + kTile - 1) / kTile;
    t.col_tiles = (W + kTile - 1) / kTile;
    t.rows = (H + t.row_tiles - 1) / t.row_tiles;
    t.cols = (W + t.col_tiles - 1) / t.col_tiles;
    return t;
  }
};

// dynamic shared memory of each kernel (ops/convnext_fused.py
// `_streamed_bytes` mirrors these)
struct Streamed {
  // taps [49][kSlice] f32, the slice's BN scale, shift and gate, and the
  // window: a tile and its halo, [rows + 6][cols + 6][kSlice] bf16
  static size_t dw_bytes(int H, int W) {
    const DwTiles t = DwTiles::of(H, W);
    return (size_t(kTaps) * kSlice + 3 * kSlice) * sizeof(float) +
           size_t(t.rows + 2 * kR) * (t.cols + 2 * kR) * kSlice * sizeof(bf16);
  }
  // the stages or the f32 tile, the column norms, the settle count and
  // list (room for every output of the tile)
  static size_t product_bytes() {
    return kUnionBytes + kBN * sizeof(float) + 4 * sizeof(unsigned) +
           size_t(kBM) * kBN * sizeof(uint16_t);
  }
  // the SE's column groups of 8 channels split R ways over the threads
  static int se_splits(int C) {
    const int c8 = C / 8;
    return c8 <= kSeThreads ? kSeThreads / c8 : 1;
  }
  // the R partial sums (none when R = 1; at most 8 kSeThreads floats)
  static size_t se_bytes(int C) {
    const int r = se_splits(C);
    return r > 1 ? size_t(r) * C * sizeof(float) : 0;
  }
};

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col): the tensor core sums the k16 step
// into 0 and d takes that sum with an IEEE f32 add (convnext_trunk.cu).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  float p[4];
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(p[0]), "=f"(p[1]), "=f"(p[2]), "=f"(p[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.f));
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += p[i];
}

__device__ __forceinline__ void unpack8(const uint4& u, float* a) {
  const bf2* p = reinterpret_cast<const bf2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    a[2 * i] = f.x;
    a[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const bf2 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const bf2*>(&u));
}

// a channel pair of a cell, through the read-only path
__device__ __forceinline__ float2 ld_pair(const bf16* p) {
  return unpack2(__ldg(reinterpret_cast<const unsigned*>(p)));
}

// sum_k a[k] * w[k * n] for k ascending, each product of two bf16 values
// exact in f32 and then added (the plain version's `_products`), a the A
// row and w the top of the matrix column (row stride n = k_len), both in
// global memory: kSettleK terms' loads issued at once, then their adds, so
// a re-sum waits on k_len / kSettleK loads in turn.
__device__ __forceinline__ float seq_dot(const bf16* a, const bf16* w, int k_len) {
  const unsigned short* wu = reinterpret_cast<const unsigned short*>(w);
  float sum = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < k_len; k0 += kSettleK) {
    uint4 av[kSettleK / 8];
    unsigned short wv[kSettleK];
#pragma unroll
    for (int i = 0; i < kSettleK / 8; ++i) av[i] = __ldg(reinterpret_cast<const uint4*>(a + k0) + i);
#pragma unroll
    for (int i = 0; i < kSettleK; ++i) wv[i] = __ldg(wu + size_t(k0 + i) * k_len);
#pragma unroll
    for (int i = 0; i < kSettleK / 8; ++i) {
      float f[8];
      unpack8(av[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        sum = __fadd_rn(sum, __fmul_rn(f[j], __bfloat162float(__ushort_as_bfloat16(wv[i * 8 + j]))));
    }
  }
  return sum;
}

// a) Depthwise 7x7 and folded BN of a tile of one board's 64-channel
// slice.  Grid (C / kSlice, B, tiles): a board of up to kTile x kTile cells
// is one tile, a larger one is cut into tiles of at most that (`DwTiles`).
// The tile's cells and their kR-cell halo, zeros off the board, sit in
// shared memory as [rows][cols][64] bf16 (a warp reads a cell's 128 bytes),
// with the slice's taps (f32), BN scale and shift.  `gate` (the previous
// block's SE gate [B][C], or null in the first block) is applied as the
// tile is loaded, x = bf16(x4 g), and that x is written to `xg` for the
// tile's own cells, the block's residual.  A warp takes items (row, strip
// of kStrip cells), its lane one channel pair, and sums each output's taps
// in the plain version's order (di, then dj, ascending; a zero off the
// board adds +0, as the plain version's padding does); the BN multiplies
// and adds with two roundings, as the plain version does.
__global__ void __launch_bounds__(kThreads)
streamed_depthwise(const bf16* __restrict__ src, const bf16* __restrict__ gate,
                   const bf16* __restrict__ dw, const float* __restrict__ bn_s,
                   const float* __restrict__ bn_t, bf16* __restrict__ ym,
                   bf16* __restrict__ xg, int H, int W, int C, DwTiles tl) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float2* taps = reinterpret_cast<float2*>(smem_raw);  // [49][32 pairs]
  float2* vs = taps + kTaps * (kSlice / 2);
  float2* vt = vs + kSlice / 2;
  float2* vg = vt + kSlice / 2;
  bf16* win = reinterpret_cast<bf16*>(vg + kSlice / 2);  // [wr][wq][kSlice]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * kSlice;
  const size_t board = blockIdx.y;
  const int tr = blockIdx.z / tl.col_tiles, tq = blockIdx.z % tl.col_tiles;
  const int r0 = tr * tl.rows, r1 = min(r0 + tl.rows, H);
  const int q0 = tq * tl.cols, q1 = min(q0 + tl.cols, W);
  const int nr = r1 - r0, nq = q1 - q0, wr = nr + 2 * kR, wq = nq + 2 * kR;
  const bool gated = gate != nullptr;
  for (int i = tid; i < kTaps * (kSlice / 2); i += kThreads) {
    const int t = i / (kSlice / 2), p = i % (kSlice / 2);
    taps[i] = ld_pair(dw + size_t(t) * C + c0 + 2 * p);
  }
  if (tid < kSlice / 2) {
    const int c = c0 + 2 * tid;
    vs[tid] = make_float2(bn_s[c], bn_s[c + 1]);
    vt[tid] = make_float2(bn_t[c], bn_t[c + 1]);
    vg[tid] = gated ? ld_pair(gate + board * C + c) : make_float2(1.f, 1.f);
  }
  __syncthreads();
  // the window, 8 channels a thread at a time (unrolled: the loads are in
  // flight together)
  const bf16* sb = src + board * H * W * C + c0;
#pragma unroll 8
  for (int i = tid; i < wr * wq * (kSlice / 8); i += kThreads) {
    const int cell = i / (kSlice / 8), ch = (i % (kSlice / 8)) * 8;
    const int rr = r0 - kR + cell / wq, cc = q0 - kR + cell % wq;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (rr >= 0 && rr < H && cc >= 0 && cc < W) {
      v = __ldg(reinterpret_cast<const uint4*>(sb + (size_t(rr) * W + cc) * C + ch));
      if (gated) {
        uint32_t* h = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = unpack2(h[k]), gk = vg[ch / 2 + k];
          h[k] = pack_bf16(f.x * gk.x, f.y * gk.y);
        }
      }
    }
    *reinterpret_cast<uint4*>(win + size_t(cell) * kSlice + ch) = v;
  }
  __syncthreads();
  if (gated) {
    bf16* xb = xg + board * H * W * C + c0;
    for (int i = tid; i < nr * nq * (kSlice / 8); i += kThreads) {
      const int cell = i / (kSlice / 8), ch = (i % (kSlice / 8)) * 8;
      const int r = cell / nq, q = cell % nq;
      *reinterpret_cast<uint4*>(xb + (size_t(r0 + r) * W + q0 + q) * C + ch) =
          *reinterpret_cast<const uint4*>(win + (size_t(r + kR) * wq + q + kR) * kSlice + ch);
    }
  }
  const float2 sc = vs[lane], sh = vt[lane];
  const bf2* w2 = reinterpret_cast<const bf2*>(win) + lane;  // this lane's pair, cell stride 32
  bf16* yb = ym + board * H * W * C + c0 + 2 * lane;
  const int strips = (nq + kStrip - 1) / kStrip;
  for (int item = warp; item < nr * strips; item += kWarps) {
    const int r = item / strips, col0 = (item % strips) * kStrip;
    float2 acc[kStrip];
#pragma unroll
    for (int o = 0; o < kStrip; ++o) acc[o] = make_float2(0.f, 0.f);
#pragma unroll 1
    for (int di = 0; di < kK; ++di) {
      float2 tap[kK];
#pragma unroll
      for (int dj = 0; dj < kK; ++dj) tap[dj] = taps[(di * kK + dj) * (kSlice / 2) + lane];
      // window row r + di is board row r0 + r + di - kR; window column
      // col0 + j is board column q0 + col0 + j - kR
      const bf2* row = w2 + size_t(r + di) * wq * (kSlice / 2);
#pragma unroll
      for (int j = 0; j < kStrip + kK - 1; ++j) {
        // past the window: inputs of outputs past the tile, never written
        const float2 v = col0 + j < wq ? __bfloat1622float2(row[(col0 + j) * (kSlice / 2)])
                                       : make_float2(0.f, 0.f);
#pragma unroll
        for (int dj = 0; dj < kK; ++dj) {
          const int o = j - dj;
          if (o >= 0 && o < kStrip) {
            acc[o].x = fmaf(v.x, tap[dj].x, acc[o].x);
            acc[o].y = fmaf(v.y, tap[dj].y, acc[o].y);
          }
        }
      }
    }
#pragma unroll
    for (int o = 0; o < kStrip; ++o) {
      if (col0 + o < nq)
        *reinterpret_cast<bf2*>(yb + (size_t(r0 + r) * W + q0 + col0 + o) * C) =
            __floats2bfloat162_rn(__fadd_rn(__fmul_rn(acc[o].x, sc.x), sh.x),
                                  __fadd_rn(__fmul_rn(acc[o].y, sc.y), sh.y));
    }
  }
}

// b), c) out = epilogue(A @ Wg + bias) over the M cells of A ([M][C] bf16)
// and Wg ([C][C] bf16, (in, out)), both in global memory.  One CTA a tile of
// kBM cells and kBN output channels (grid: the C / kBN column tiles of a
// row tile side by side, so that the CTAs that read the same A rows run
// together and find them in L2), 8 warps of 32 x 32.  kRes false:
// relu(acc + bias) to bf16; true: bf16(bf16(acc + bias) + res).  Rows past
// M read row M - 1 and are never written.
template <bool kRes>
__global__ void __launch_bounds__(kThreads, 2)
streamed_product(const bf16* __restrict__ A, const bf16* __restrict__ Wg,
                 const float* __restrict__ bias, const bf16* __restrict__ res,
                 bf16* __restrict__ out, int M, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);   // [kStages][kBM][kAS]
  bf16* sb = sa + kStages * kBM * kAS;            // [kStages][kBK][kBS]
  float* cs = reinterpret_cast<float*>(smem_raw);  // [kBM][kCS], after the k loop
  float* wn = reinterpret_cast<float*>(smem_raw + kUnionBytes);  // [kBN]
  unsigned* cnt = reinterpret_cast<unsigned*>(wn + kBN);
  uint16_t* list = reinterpret_cast<uint16_t*>(cnt + 4);  // row * kBN + col
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nt = C / kBN;
  const int n0 = (blockIdx.x % nt) * kBN;
  const size_t m0 = size_t(blockIdx.x / nt) * kBM;
  const int wm = (warp & 3) * 32, wc = (warp >> 2) * 32;  // this warp's rows and columns
  const int S = C / kBK;

  auto load_stage = [&](int s, int buf) {
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = i % (kBK / 8);
      const size_t row = m0 + r < size_t(M) ? m0 + r : size_t(M) - 1;
      cp_async16(sa + (buf * kBM + r) * kAS + c * 8, A + row * C + s * kBK + c * 8);
    }
    for (int i = tid; i < kBK * (kBN / 8); i += kThreads) {
      const int r = i / (kBN / 8), c = i % (kBN / 8);
      cp_async16(sb + (buf * kBK + r) * kBS + c * 8, Wg + size_t(s * kBK + r) * C + n0 + c * 8);
    }
  };

  float acc[2][4][4], rn[2][2];
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    rn[m][0] = rn[m][1] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
  }
  float nsq = 0.f;  // column tid's sum of squares (tid < kBN)
  if (tid == 0) *cnt = 0;  // ordered before any use by the loop's barriers
  // the k stages through a ring of kStages buffers
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < S) load_stage(s, s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int s = 0; s < S; ++s) {
    cp_async_wait<kStages - 2>();
    // stage s has landed, and every warp is done with stage s - 1's buffer
    __syncthreads();
    if (s + kStages - 1 < S) load_stage(s + kStages - 1, (s + kStages - 1) % kStages);
    cp_async_commit();
    const bf16* as = sa + (s % kStages) * kBM * kAS;
    const bf16* bs = sb + (s % kStages) * kBK * kBS;
    if (tid < kBN) {
#pragma unroll 8
      for (int k = 0; k < kBK; ++k) {
        const float v = __bfloat162float(bs[k * kBS + tid]);
        nsq = fmaf(v, v, nsq);
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t b[2][4];
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
        ldmatrix_x4_trans(b[nn], smem_u32(bs + (kk * 16 + (lane & 15)) * kBS + wc + nn * 16 +
                                          (lane >> 4) * 8));
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        uint32_t af[4];
        ldmatrix_x4(af, smem_u32(as + (wm + m * 16 + (lane & 15)) * kAS + kk * 16 +
                                 (lane >> 4) * 8));
        // registers 0 and 2 hold row g, 1 and 3 row g + 8
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 f = unpack2(af[r]);
          rn[m][r & 1] = fmaf(f.x, f.x, fmaf(f.y, f.y, rn[m][r & 1]));
        }
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          mma_bf16(acc[m][2 * nn], af, b[nn][0], b[nn][1]);
          mma_bf16(acc[m][2 * nn + 1], af, b[nn][2], b[nn][3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  // every warp is done with the stages: the f32 tile takes their place
  __syncthreads();
  if (tid < kBN) wn[tid] = kErr * sqrtf(nsq);
  // the 2-norms of this lane's rows: the quad's 4 lanes hold 16 k each
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = rn[m][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      rn[m][h] = sqrtf(v);
    }
  __syncthreads();
  // the sums into the tile, each doubtful one listed
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = wm + m * 16 + g + 8 * (q >> 1);
        const int col = wc + j * 8 + 2 * t + (q & 1);
        const float v = acc[m][j][q];
        cs[row * kCS + col] = v;
        if (m0 + row < size_t(M)) {
          const float e = rn[m][q >> 1] * wn[col];
          const float bv = __ldg(bias + n0 + col);
          float lo = __fsub_rd(v, e) + bv;
          float hi = __fadd_ru(v, e) + bv;
          if (!kRes) {
            lo = fmaxf(lo, 0.f);
            hi = fmaxf(hi, 0.f);
          }
          if (__bfloat16_as_ushort(__float2bfloat16_rn(lo)) !=
              __bfloat16_as_ushort(__float2bfloat16_rn(hi))) {
            list[atomicAdd(cnt, 1u)] = static_cast<uint16_t>(row * kBN + col);
          }
        }
      }
  __syncthreads();
  // the listed outputs summed again in the plain order, a thread each
  const int listed = static_cast<int>(*cnt);
  for (int e = tid; e < listed; e += kThreads) {
    const int row = list[e] / kBN, col = list[e] % kBN;
    cs[row * kCS + col] = seq_dot(A + (m0 + row) * C, Wg + n0 + col, C);
  }
  __syncthreads();
  // the epilogue, 8 channels of a cell a thread (two at once: the
  // residual's loads in flight together)
#pragma unroll 2
  for (int i = tid; i < kBM * (kBN / 8); i += kThreads) {
    const int row = i / (kBN / 8), c8 = (i % (kBN / 8)) * 8;
    if (m0 + row >= size_t(M)) continue;
    const float4* cv = reinterpret_cast<const float4*>(cs + row * kCS + c8);
    const float4* bv = reinterpret_cast<const float4*>(bias + n0 + c8);
    const float4 v0 = cv[0], v1 = cv[1], b0 = __ldg(bv), b1 = __ldg(bv + 1);
    const float v[8] = {v0.x + b0.x, v0.y + b0.y, v0.z + b0.z, v0.w + b0.w,
                        v1.x + b1.x, v1.y + b1.y, v1.z + b1.z, v1.w + b1.w};
    const size_t off = (m0 + row) * C + n0 + c8;
    uint4 o;
    uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
    if (!kRes) {
#pragma unroll
      for (int h = 0; h < 4; ++h) ow[h] = pack_bf16(fmaxf(v[2 * h], 0.f), fmaxf(v[2 * h + 1], 0.f));
    } else {
      float x[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(res + off)), x);
#pragma unroll
      for (int h = 0; h < 4; ++h)
        ow[h] = pack_bf16(round_bf16(v[2 * h]) + x[2 * h], round_bf16(v[2 * h + 1]) + x[2 * h + 1]);
    }
    *reinterpret_cast<uint4*>(out + off) = o;
  }
}

// The column groups (8 channels) of a SE thread tid, and its split r of
// R: with R > 1 one group and the rows (cells, or a dense's inputs) r,
// r + R, ...; with R = 1 every kSeThreads-th group and every row.
struct SeSplit {
  int first, step, r, R;
  __device__ SeSplit(int C, int tid) {
    const int c8 = C / 8;
    R = c8 <= kSeThreads ? kSeThreads / c8 : 1;
    if (R > 1) {
      first = tid / c8 < R ? tid % c8 : c8;  // threads past R c8 idle
      step = c8;
      r = tid / c8;
    } else {
      first = tid;
      step = kSeThreads;
      r = 0;
    }
  }
};

// For each channel c, the sum over `rows` rows of what `add(row, cg, a)`
// adds into a[8] (channels 8 cg ..): each thread takes its rows in order,
// and the R splits' sums are added in r order through `red` ([R][C]), so
// the same inputs give the same bits on every run; `finish(c, sum)` takes
// each channel's sum.
template <typename Add, typename Finish>
__device__ __forceinline__ void se_sum(int rows, int C, const SeSplit& sp, float* red, int tid,
                                       Add add, Finish finish) {
  const int c8 = C / 8;
  for (int cg = sp.first; cg < c8; cg += sp.step) {
    float a[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = 0.f;
#pragma unroll 8
    for (int row = sp.r; row < rows; row += sp.R) add(row, cg, a);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (sp.R > 1)
        red[size_t(sp.r) * C + cg * 8 + i] = a[i];
      else
        finish(cg * 8 + i, a[i]);
    }
  }
  __syncthreads();
  if (sp.R > 1) {
    for (int c = tid; c < C; c += kSeThreads) {
      float sum = 0.f;
      for (int r = 0; r < sp.R; ++r) sum += red[size_t(r) * C + c];
      finish(c, sum);
    }
  }
  __syncthreads();
}

// d) The SE gate of one board (grid B, kSeThreads threads: a board's sums
// split over many threads, so that a small batch is not a few long chains
// of loads): z = bf16(mean of x4 over the HW cells), h1 = bf16(relu(z sw1
// + sb1)), gate = bf16(sigmoid(h1 sw2 + sb2)).  z and h1 go through global
// memory (f32, [B][C]), so that the shared memory does not grow with C.
__global__ void __launch_bounds__(kSeThreads)
streamed_se(const bf16* __restrict__ x4, const bf16* __restrict__ sw1,
            const float* __restrict__ sb1, const bf16* __restrict__ sw2,
            const float* __restrict__ sb2, float* z, float* h1, bf16* __restrict__ gate,
            int HW, int C) {
  extern __shared__ __align__(16) float red[];  // [R][C] when R > 1
  const int tid = threadIdx.x;
  const size_t board = blockIdx.x;
  const SeSplit sp(C, tid);
  const int c8 = C / 8;
  const float cells = float(HW);
  float* zb = z + board * C;
  float* hb = h1 + board * C;
  const uint4* xb = reinterpret_cast<const uint4*>(x4 + board * HW * C);
  const uint4* w1 = reinterpret_cast<const uint4*>(sw1);
  const uint4* w2 = reinterpret_cast<const uint4*>(sw2);
  se_sum(HW, C, sp, red, tid, [&](int cell, int cg, float (&a)[8]) {
    float f[8];
    unpack8(__ldg(xb + size_t(cell) * c8 + cg), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] += f[i];
  }, [&](int c, float sum) { zb[c] = round_bf16(sum / cells); });
  se_sum(C, C, sp, red, tid, [&](int ci, int cg, float (&a)[8]) {
    float f[8];
    unpack8(__ldg(w1 + size_t(ci) * c8 + cg), f);
    const float v = zb[ci];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = fmaf(v, f[i], a[i]);
  }, [&](int c, float sum) { hb[c] = round_bf16(fmaxf(sum + sb1[c], 0.f)); });
  se_sum(C, C, sp, red, tid, [&](int ci, int cg, float (&a)[8]) {
    float f[8];
    unpack8(__ldg(w2 + size_t(ci) * c8 + cg), f);
    const float v = hb[ci];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = fmaf(v, f[i], a[i]);
  }, [&](int c, float sum) {
    gate[board * C + c] = __float2bfloat16_rn(1.f / (1.f + expf(-(sum + sb2[c]))));
  });
}

// After the last block: out = bf16(x4 * gate), 8 channels a thread.
__global__ void __launch_bounds__(kThreads)
streamed_scale(const bf16* __restrict__ x4, const bf16* __restrict__ gate,
               bf16* __restrict__ out, int HW, int C, size_t n8) {
  const int c8 = C / 8;
  for (size_t i = size_t(blockIdx.x) * kThreads + threadIdx.x; i < n8;
       i += size_t(gridDim.x) * kThreads) {
    const size_t board = i / (size_t(HW) * c8);
    const int cg = static_cast<int>(i % c8);
    float x[8], gv[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(x4) + i), x);
    unpack8(__ldg(reinterpret_cast<const uint4*>(gate + board * C) + cg), gv);
    uint4 o;
    uint32_t* ow = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int h = 0; h < 4; ++h) ow[h] = pack_bf16(x[2 * h] * gv[2 * h], x[2 * h + 1] * gv[2 * h + 1]);
    reinterpret_cast<uint4*>(out)[i] = o;
  }
}

cudaError_t prepare(int C, int H, int W) {
  const void* fns[4] = {(const void*)streamed_depthwise, (const void*)streamed_product<false>,
                        (const void*)streamed_product<true>, (const void*)streamed_se};
  const size_t smem[4] = {Streamed::dw_bytes(H, W), Streamed::product_bytes(),
                          Streamed::product_bytes(), Streamed::se_bytes(C)};
  cudaError_t err = cudaSuccess;
  for (int k = 0; k < 4 && err == cudaSuccess; ++k) {
    err = cudaFuncSetAttribute(fns[k], cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem[k]));
    // as much of the SM's L1 as shared memory as it takes, so that two
    // CTAs of 100 KB fit an SM
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fns[k], cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
  }
  return err;
}

}  // namespace

// The streamed entry: C a multiple of 64 (above 256 by the wrapper's plan),
// any board.  x, out and the scratch ym, y1, xg, x4 are [B][H][W][C] bf16;
// z and h1 [B][C] f32, gate [B][C] bf16.  4 L + 1 launches on `stream`.
extern "C" int ag_convnext_trunk_streamed(
    const void* x, const void* dw, const void* bn_s, const void* bn_t, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* sw1, const void* sb1,
    const void* sw2, const void* sb2, void* out, void* ym, void* y1, void* xg, void* x4,
    void* z, void* h1, void* gate, int B, int H, int W, int C, int L, void* stream) {
  // the depthwise grid takes the boards in y (at most 65,535)
  if (C <= 0 || C % kSlice != 0 || H <= 0 || W <= 0 || L < 0 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t HW = size_t(H) * W, M = size_t(B) * HW;
  if (L == 0)
    return static_cast<int>(
        cudaMemcpyAsync(out, x, M * C * sizeof(bf16), cudaMemcpyDeviceToDevice, st));
  if (M > size_t(INT32_MAX) || (M + kBM - 1) / kBM * (C / kBN) > size_t(INT32_MAX))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(C, H, W);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Weights wt{static_cast<const bf16*>(dw),    static_cast<const bf16*>(w1),
                   static_cast<const bf16*>(w2),    static_cast<const bf16*>(sw1),
                   static_cast<const bf16*>(sw2),   static_cast<const float*>(bn_s),
                   static_cast<const float*>(bn_t), static_cast<const float*>(b1),
                   static_cast<const float*>(b2),   static_cast<const float*>(sb1),
                   static_cast<const float*>(sb2)};
  const bf16* xin = static_cast<const bf16*>(x);
  bf16* ymb = static_cast<bf16*>(ym);
  bf16* y1b = static_cast<bf16*>(y1);
  bf16* xgb = static_cast<bf16*>(xg);
  bf16* x4b = static_cast<bf16*>(x4);
  bf16* gb = static_cast<bf16*>(gate);
  const DwTiles tl = DwTiles::of(H, W);
  const dim3 dw_grid(C / kSlice, B, tl.row_tiles * tl.col_tiles);
  const unsigned tiles = static_cast<unsigned>((M + kBM - 1) / kBM * (C / kBN));
  const size_t cc = size_t(C) * C;
  for (int l = 0; l < L; ++l) {
    // the first block reads the trunk's input, ungated, as its residual
    const bf16* src = l == 0 ? xin : x4b;
    const bf16* res = l == 0 ? xin : xgb;
    streamed_depthwise<<<dw_grid, kThreads, Streamed::dw_bytes(H, W), st>>>(
        src, l == 0 ? nullptr : gb, wt.dw + size_t(l) * kTaps * C, wt.bn_s + size_t(l) * C,
        wt.bn_t + size_t(l) * C, ymb, xgb, H, W, C, tl);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    streamed_product<false><<<tiles, kThreads, Streamed::product_bytes(), st>>>(
        ymb, wt.w1 + l * cc, wt.b1 + size_t(l) * C, nullptr, y1b, static_cast<int>(M), C);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    streamed_product<true><<<tiles, kThreads, Streamed::product_bytes(), st>>>(
        y1b, wt.w2 + l * cc, wt.b2 + size_t(l) * C, res, x4b, static_cast<int>(M), C);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    streamed_se<<<B, kSeThreads, Streamed::se_bytes(C), st>>>(
        x4b, wt.sw1 + l * cc, wt.sb1 + size_t(l) * C, wt.sw2 + l * cc, wt.sb2 + size_t(l) * C,
        static_cast<float*>(z), static_cast<float*>(h1), gb, static_cast<int>(HW), C);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  const size_t n8 = M * C / 8;
  const size_t blocks = (n8 + kThreads - 1) / kThreads;
  streamed_scale<<<static_cast<unsigned>(blocks < 65535 ? blocks : 65535), kThreads, 0, st>>>(
      x4b, gb, static_cast<bf16*>(out), static_cast<int>(HW), C, n8);
  return static_cast<int>(cudaGetLastError());
}

// What the streamed entry's kernels get from the card at width C on H x W
// boards: for each of depthwise, product 1, product 2, SE and scale,
// info[4 k + 0] CTAs per SM, [4 k + 1] registers per thread, [4 k + 2]
// shared memory per CTA (bytes, dynamic and static), [4 k + 3] local
// memory (spills) per thread (bytes).
extern "C" int ag_convnext_trunk_streamed_occupancy(int C, int H, int W, int* info) {
  if (C <= 0 || C % kSlice != 0 || H <= 0 || W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = prepare(C, H, W);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* fns[5] = {(const void*)streamed_depthwise,
                        (const void*)streamed_product<false>,
                        (const void*)streamed_product<true>,
                        (const void*)streamed_se,
                        (const void*)streamed_scale};
  const size_t smem[5] = {Streamed::dw_bytes(H, W), Streamed::product_bytes(),
                          Streamed::product_bytes(), Streamed::se_bytes(C), 0};
  const int threads[5] = {kThreads, kThreads, kThreads, kSeThreads, kThreads};
  for (int k = 0; k < 5; ++k) {
    cudaFuncAttributes attr;
    if ((err = cudaFuncGetAttributes(&attr, fns[k])) != cudaSuccess)
      return static_cast<int>(err);
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[4 * k], fns[k], threads[k],
                                                             smem[k])) != cudaSuccess)
      return static_cast<int>(err);
    info[4 * k + 1] = attr.numRegs;
    info[4 * k + 2] = static_cast<int>(smem[k] + attr.sharedSizeBytes);
    info[4 * k + 3] = static_cast<int>(attr.localSizeBytes);
  }
  return 0;
}
