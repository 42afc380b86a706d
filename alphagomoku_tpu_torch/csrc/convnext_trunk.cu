// Fused ConvNext trunk for Hopper: all L blocks of the trunk in one launch,
// each board's activation kept in shared memory throughout.  One kernel,
// templated on the width C and built for C = 64 (the 6x64 flagship) and
// C = 128 (the 8x128 network); narrower trunks run at the next width on
// zero channels (ops/convnext_fused.py `pad_trunk`).  A second entry,
// `convnext_trunk_cluster_kernel<128>`, takes C = 128 on boards whose
// activations do not fit one CTA (above 252 cells: 16x16 to 20x20), as a
// cluster of two CTAs a board (see the end of this comment).
//
// Replaces the Pallas TPU kernel `_trunk_kernel` of
// alphagomoku_tpu/ops/convnext_fused.py (wrapper `fused_trunk`).  Per
// block: depthwise 7x7 (f32 accumulation over the 49 taps), folded
// BatchNorm, a C->C pointwise layer with bias and relu, a C->C pointwise
// layer with bias, residual add, then a squeeze-excitation gate (spatial
// mean in f32, dense + relu, dense + sigmoid) scaling the channels.  The
// rounding points are the Pallas body's: activations are stored in bf16,
// sums are f32, and values are cast to bf16 after the BN, after each
// pointwise layer, after the residual add, after the mean, after each SE
// dense and after the channel scale.
//
// What bounds it on the H100: operations.  At B = 1280 the trunk moves
// little (the activation crosses HBM once each way: about 74 MB at C = 64,
// L = 6, and 147 MB at C = 128, L = 8) but needs 2*49*H*W*C*B*L FLOP of
// f32 depthwise work on CUDA cores (10.8 GFLOP at C = 64, 28.9 GFLOP at
// C = 128) and about 4*H*W*C*C*B*L FLOP of pointwise and SE products (28
// and 152 GFLOP).  The products run on tensor cores here, so the f32
// depthwise at 67 TFLOP/s sets the least time: about 0.19 ms at C = 64 and
// 0.585 ms at C = 128.
//
// Design, one CTA of 8 warps per board:
// - Shared memory holds the activation and the depthwise + BN output as
//   [H*W][C] bf16 with rows C + 8 wide: the 16 bytes of padding put the 8
//   rows an `ldmatrix` reads in 8 different bank groups, and keep the
//   depthwise's addresses plain offsets.  w1 and w2 ([in][out], the same
//   row stride), the taps and the BN/bias vectors are staged beside them:
//   96 KB at C = 64 (two CTAs per SM), 217 KB at C = 128 (one).
// - Depthwise: a thread takes one channel pair of a strip of 15 cells of
//   a row (a whole row of a 15x15 board) and reads the taps one row of 7
//   at a time from shared memory; each input it loads serves up to 7 taps.
//   The taps of a cell are summed in the plain version's order, and the BN
//   multiplies and adds with two roundings, as the plain version does.
// - Both pointwise products on tensor cores: `mma.sync` m16n8k16, bf16 in,
//   f32 sums.  The H*W cells are m16 tiles (the last one's rows past H*W
//   read a valid row, are never written back and are left out of the SE
//   sums), one tile per warp at a time.  A fragments of product 1 come
//   from the depthwise buffer by `ldmatrix`, B fragments from w1/w2 by
//   `ldmatrix.trans`; product 1's accumulators, plus b1, through relu and
//   rounded to bf16, are product 2's A fragments in registers (the m16n8
//   accumulator layout is the m16n8k16 A layout, two n8 tiles per k16).
//   Product 2's epilogue adds b2, rounds, adds the residual, rounds,
//   writes the cell back in place and sums each column for the SE mean.
// - The products' roundings are settled in the plain version's sum order
//   (settle()): the few outputs whose bf16 rounding the tensor cores' sum
//   leaves in doubt are summed again on CUDA cores, k ascending, reading
//   the relu output, which for that only is also kept in the depthwise
//   buffer's rows.  Without it the 8 blocks of the seeded 8x128 trunk
//   leave the plain version's result in 34% to 38% of the elements
//   (TRUNK_LIMITS allow 25%).  At C = 64 the tensor cores' sums kept 1,280
//   boards within the limits as a whole, but a board alone is another
//   matter: on a board with few stones the cells share their values, so
//   one rounding the tensor cores turn spreads over most of the board
//   (65 of 256 network_23 bench boards alone over the limits, up to 88% of
//   the elements), and the engine evaluates one board at a time.  So both
//   widths settle; with it the kernel equals the plain version, whose
//   products sum k ascending (`_products` in ops/convnext_fused.py), bit
//   for bit on those boards, at 1.78x the time at C = 64 and B = 1280.
// - Weights are fetched ahead: once the pointwise of layer l has passed
//   its barrier, layer l+1's taps, w1, w2 and vectors are dead, so their
//   `cp.async` copies are issued then and fly during layer l's SE gate and
//   channel scale.  The board's activation arrives the same way.
// - SE gate on every thread: the SE weights are read as coalesced 16-byte
//   loads spread over all 256 threads, issued right after the pointwise
//   (before its barrier), so each thread keeps C*C/2048 loads per dense in
//   flight; each dense is split over all warps and reduced by shuffles and
//   a per-warp row of partial sums.
//
// The cluster entry (C = 128 above 252 cells, where one CTA would need
// 234,240 B at 16x16 up to 312,576 B at 20x20 against the card's 232,448):
// a cluster of two CTAs a board, CTA r holding rows [r * ceil(H/2), ...):
// its own rows' activation and depthwise output, the 3 rows of the other
// half its depthwise reads (the halo), and its own copy of w1, w2, the taps
// and the vectors (220,608 B at 20x20).  Each block: the halo rows are
// copied from the other CTA's activation through distributed shared memory
// between two cluster barriers (the second keeps the other CTA's in-place
// pointwise from overwriting them early); the depthwise, the products with
// their settle() and the channel scale run on the CTA's own rows as in the
// one-CTA kernel, with the same rounding points; the SE mean adds the two
// CTAs' column sums (CTA 0's first on both, so both gate alike) after a
// third barrier, and both run the SE denses.  A last barrier keeps a CTA's
// shared memory alive until the other has read it.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kK = 7;             // depthwise kernel
constexpr int kR = kK / 2;        // its radius
constexpr int kTaps = kK * kK;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStrip = 15;        // depthwise output cells per thread pass (one row)

using bf16 = __nv_bfloat16;
using bf2 = __nv_bfloat162;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Weights {
  const bf16 *dw, *w1, *w2, *sw1, *sw2;
  const float *bn_s, *bn_t, *b1, *b2, *sb1, *sb2;
};

template <int C>
struct Trunk {
  static constexpr int C2 = C / 2;     // channel pairs
  static constexpr int C8 = C / 8;     // 16-byte chunks per row
  static constexpr int RS = C + 8;     // row stride (bf16) of the [rows][C] buffers
  static constexpr int RS2 = RS / 2;
  static constexpr int KT = C / 16;    // k16 steps of a product
  static constexpr int MT = 1;         // m16 tiles a warp takes at once
  // settle the products' roundings in the plain version's sum order (see
  // settle()); tools/trunk_settle.py builds copies with it off
  static constexpr bool kExact = true;
  static constexpr int NC = 32;        // output columns per pass of a product
  static constexpr int SE_LOADS = C * C / 8 / kThreads;  // 16-byte loads per thread per dense
  static constexpr int kMinBlocks = C == 64 ? 2 : 1;     // CTAs per SM
  static_assert(C % NC == 0 && NC % 16 == 0 && SE_LOADS >= 1 && (C * C / 8) % kThreads == 0,
                "C must be 64 or 128");

  // dynamic shared memory of one CTA
  static size_t bytes(int H, int W) {
    const size_t hw = size_t(H) * W;
    return (2 * hw * RS + 2 * size_t(C) * RS + kTaps * C) * sizeof(bf16) +
           (4 * C + 2 * kWarps * C + 3 * C + 2 * C) * sizeof(float);
  }
  // dynamic shared memory of one CTA of the cluster entry: the larger
  // half's rows plus the halo, the depthwise output of the larger half,
  // and one more f32 vector (the CTA's SE column sums)
  static size_t cluster_bytes(int H, int W) {
    const size_t top = (H + 1) / 2;
    return ((2 * top + kR) * W * RS + 2 * size_t(C) * RS + kTaps * C) * sizeof(bf16) +
           (4 * C + 2 * kWarps * C + 3 * C + 2 * C + C) * sizeof(float);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// four 8x8 bf16 matrices; lane i gives the shared-memory address of row
// i % 8 of matrix i / 8
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

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 sums.  The tensor
// core sums the 16 products of a k16 step into 0 (its adder aligns to the
// largest term and truncates), and d takes that sum with an IEEE f32 add,
// which keeps the sums closer to the plain version's than chaining d
// through the tensor core.
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const bf2 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const bf2*>(&u));
}

// Square roots of sums of squares held by the 4 lanes of a quad.
template <int MT>
__device__ __forceinline__ void quad_norms(float (&rn)[MT][2]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = rn[m][h];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      rn[m][h] = sqrtf(v);
    }
}

// sum_k a[k] * w[k][0] in the plain version's order (k ascending, one f32
// rounding per step), a a row of C bf16 and w a column of the [C][RS]
// matrix, both in shared memory.
template <int C>
__device__ __forceinline__ float seq_dot(const bf16* a, const bf16* w) {
  float s = 0.f;
#pragma unroll 4
  for (int k0 = 0; k0 < C; k0 += 8) {
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(a + k0), f);
#pragma unroll
    for (int i = 0; i < 8; ++i) s = fmaf(f[i], __bfloat162float(w[(k0 + i) * Trunk<C>::RS]), s);
  }
  return s;
}

// The products' exact path.  A product's f32 sum from the tensor cores
// and the plain version's k-ascending sum (one f32 rounding per term)
// differ by a few f32 roundings, and in a trunk of random weights each
// bf16 rounding that this turns spreads through the blocks after it: at
// C = 128 the tensor cores' sums alone leave 34% to 38% of the 8-block
// trunk's elements differing from the plain version's.  So each output of
// this lane whose value after + bias (and relu for product 1) rounds to
// another bf16 at the two ends of acc -/+ kErr |a| |w| (|a|, |w| the 2-norms
// of its A row and matrix column, which bound sum_k |a_k w_k|) has its sum
// taken again in the plain order (seq_dot).  kErr = u (2^-24) is
// calibrated on the card: at u and 2 u the seeded 8x128 trunk came out
// bit for bit as with the provable bound (K + K/16 + 40) u, which settles
// 79x more outputs (9.4% against 0.12%); at u / 2 a few roundings were
// missed.  acc is the lane's [MT][NJ] m16n8 accumulators of columns
// col0.., rn the norms of its rows, wn the columns' norms times kErr; a
// holds the product's A rows, w its matrix.
constexpr float kErr = 5.9604645e-8f;

template <int C, int MT, int NJ>
__device__ __forceinline__ void settle(float (&acc)[MT][NJ][4], const float (&rn)[MT][2],
                                       const float* wn, const float* bias, const bf16* a,
                                       const bf16* w, int m0, int col0, int HW, int g, int t,
                                       bool relu) {
  static_assert(MT * NJ * 4 <= 32, "one flag bit per output");
  uint32_t flags = 0;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int row = (m0 + m) * 16 + g + 8 * (q >> 1);
        const int col = col0 + j * 8 + 2 * t + (q & 1);
        const float e = rn[m][q >> 1] * wn[col];
        float lo = __fsub_rd(acc[m][j][q], e) + bias[col];
        float hi = __fadd_ru(acc[m][j][q], e) + bias[col];
        if (relu) {
          lo = fmaxf(lo, 0.f);
          hi = fmaxf(hi, 0.f);
        }
        if (row < HW && __bfloat16_as_ushort(__float2bfloat16_rn(lo)) !=
                            __bfloat16_as_ushort(__float2bfloat16_rn(hi)))
          flags |= 1u << ((m * NJ + j) * 4 + q);
      }
  while (flags) {
    const int i = __ffs(flags) - 1;
    flags &= flags - 1;
    const int q = i & 3, j = (i >> 2) % NJ, m = (i >> 2) / NJ;
    const float s = seq_dot<C>(a + ((m0 + m) * 16 + g + 8 * (q >> 1)) * Trunk<C>::RS,
                               w + col0 + j * 8 + 2 * t + (q & 1));
#pragma unroll
    for (int mm = 0; mm < MT; ++mm)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int qq = 0; qq < 4; ++qq)
          if ((mm * NJ + jj) * 4 + qq == i) acc[mm][jj][qq] = s;
  }
}

// Copy layer l's taps, w1, w2 and BN/bias vectors into shared memory
// (cp.async; the caller commits the group).
template <int C>
__device__ __forceinline__ void stage_layer(const Weights& wt, int l, bf16* dw, bf16* w1,
                                            bf16* w2, float* vec, int tid) {
  using G = Trunk<C>;
  const bf16* gdw = wt.dw + size_t(l) * kTaps * C;
  for (int i = tid; i < kTaps * G::C8; i += kThreads) cp_async16(dw + i * 8, gdw + i * 8);
  const size_t mat = size_t(l) * C * C;
  for (int i = tid; i < C * G::C8; i += kThreads) {
    const int r = i / G::C8, c = i % G::C8;
    cp_async16(w1 + r * G::RS + c * 8, wt.w1 + mat + i * 8);
    cp_async16(w2 + r * G::RS + c * 8, wt.w2 + mat + i * 8);
  }
  for (int i = tid; i < C / 4; i += kThreads) {
    const size_t o = size_t(l) * C + i * 4;
    cp_async16(vec + i * 4, wt.bn_s + o);
    cp_async16(vec + C + i * 4, wt.bn_t + o);
    cp_async16(vec + 2 * C + i * 4, wt.b1 + o);
    cp_async16(vec + 3 * C + i * 4, wt.b2 + o);
  }
}

// Depthwise 7x7 + folded BN of the activation into ybuf (bf16).  An item
// is (row, strip, channel pair); a thread sums a strip of kStrip cells of
// one row for one pair, so each input it loads serves up to 7 taps, and
// reads the taps one row of 7 at a time.  kFixedW: the board is kStrip
// wide, so the strip is the row and every bound on a column is known when
// compiling.  kBand (the cluster entry): act is a window of `in_rows` rows
// and output row r is centred on its row r + `shift`; otherwise act is the
// board (H rows, shift 0).
template <int C, bool kFixedW, bool kBand = false>
__device__ __forceinline__ void depthwise(const bf16* act, const bf16* dw, bf16* ybuf,
                                          const float* bn_s, const float* bn_t, int H,
                                          int width, int tid, int shift = 0, int in_rows = 0) {
  constexpr int C2 = Trunk<C>::C2, RS2 = Trunk<C>::RS2;
  const int W = kFixedW ? kStrip : width;
  const int top = kBand ? shift : 0;
  const int rows = kBand ? in_rows : H;
  const bf2* act2 = reinterpret_cast<const bf2*>(act);
  const bf2* dw2 = reinterpret_cast<const bf2*>(dw);
  bf2* y2 = reinterpret_cast<bf2*>(ybuf);
  const int per_row = kFixedW ? 1 : (W + kStrip - 1) / kStrip;
  for (int it = tid; it < H * per_row * C2; it += kThreads) {
    const int p = it % C2, s = it / C2;
    const int r = s / per_row, c0 = kFixedW ? 0 : (s % per_row) * kStrip;
    float2 acc[kStrip];
#pragma unroll
    for (int o = 0; o < kStrip; ++o) acc[o] = make_float2(0.f, 0.f);
#pragma unroll 1
    for (int di = 0; di < kK; ++di) {
      const int rr = r + top + di - kR;
      if (rr < 0 || rr >= rows) continue;
      float2 tap[kK];
#pragma unroll
      for (int dj = 0; dj < kK; ++dj) tap[dj] = __bfloat1622float2(dw2[(di * kK + dj) * C2 + p]);
      const bf2* row = act2 + (rr * W + c0) * RS2 + p;
#pragma unroll
      for (int j = 0; j < kStrip + kK - 1; ++j) {
        const int cc = c0 + j - kR;
        if (kFixedW && (j < kR || j - kR >= kStrip)) continue;
        float2 v = make_float2(0.f, 0.f);
        if (kFixedW || (cc >= 0 && cc < W)) v = __bfloat1622float2(row[(j - kR) * RS2]);
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
    // the plain version's BN: a multiply and an add, each rounded
    const float s0 = bn_s[2 * p], s1 = bn_s[2 * p + 1];
    const float t0 = bn_t[2 * p], t1 = bn_t[2 * p + 1];
#pragma unroll
    for (int o = 0; o < kStrip; ++o) {
      if (c0 + o < W)
        y2[(r * W + c0 + o) * RS2 + p] =
            __floats2bfloat162_rn(__fadd_rn(__fmul_rn(acc[o].x, s0), t0),
                                  __fadd_rn(__fmul_rn(acc[o].y, s1), t1));
    }
  }
}

// Per-warp partial sums of an SE dense layer, sum_ci in[ci] * w[ci][co]:
// thread tid holds the 16-byte chunks tid + 256 k of w ([C][C] bf16), all
// of one column group; lanes of a column group are summed by shuffles and
// each warp writes its C sums to part[warp][C].
template <int C>
__device__ __forceinline__ void dense_partial(const float* in,
                                              const uint4 (&w)[Trunk<C>::SE_LOADS],
                                              float* part, int tid) {
  constexpr int C8 = Trunk<C>::C8, ROWS = kThreads / C8;
  const int cg = tid % C8, r0 = tid / C8, lane = tid & 31;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll
  for (int k = 0; k < Trunk<C>::SE_LOADS; ++k) {
    const float v = in[r0 + k * ROWS];
    float f[8];
    unpack8(w[k], f);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = fmaf(v, f[i], acc[i]);
  }
#pragma unroll
  for (int off = C8; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  if (lane < C8) {
#pragma unroll
    for (int i = 0; i < 8; ++i) part[(tid >> 5) * C + cg * 8 + i] = acc[i];
  }
}

// The phases of a block, for the cluster entry.  The one-CTA kernel below
// writes each of them out in its body (see there why): every helper here
// has a twin there, named in a "twin:" comment at both, and an edit to one
// (a rounding point, settle()'s use) is made to both.  Only the card tests
// against the plain trunk would catch the two drifting apart.

// Column 2-norms of w1 and w2 times kErr, for settle().
// twin: the kExact norms at the top of convnext_trunk_kernel's layer loop.
template <int C>
__device__ __forceinline__ void column_norms(const bf16* w1, const bf16* w2, float* wnorm,
                                             int tid) {
  constexpr int RS = Trunk<C>::RS;
  for (int i = tid; i < 2 * C; i += kThreads) {
    const bf16* wc = (i < C ? w1 : w2) + i % C;
    float n = 0.f;
#pragma unroll 8
    for (int k = 0; k < C; ++k) {
      const float v = __bfloat162float(wc[k * RS]);
      n = fmaf(v, v, n);
    }
    wnorm[i] = kErr * sqrtf(n);
  }
}

// Both pointwise products of the HW cells of act / ybuf: relu(y @ w1 + b1)
// (bf16, kept as A fragments) and y2 = . @ w2 + b2 (bf16), residual add
// (bf16) in place in act, and each warp's column sums of the result in
// red[warp][C] for the SE mean.
// twin: the "pointwise on tensor cores" block of convnext_trunk_kernel.
template <int C>
__device__ __forceinline__ void pointwise(bf16* act, bf16* ybuf, const bf16* w1, const bf16* w2,
                                          const float* wnorm, const float* b1, const float* b2,
                                          float* red, int HW, int warp, int lane) {
  using G = Trunk<C>;
  constexpr int RS = G::RS, KT = G::KT, MT = G::MT, NC = G::NC;
  // pointwise on tensor cores: MT m16 tiles per warp through
  // relu(y @ w1 + b1) (bf16, kept as A fragments) and y2 = . @ w2 + b2
  // (bf16), residual add (bf16) in place, column sums for the SE mean.
  // With kExact, every output whose bf16 rounding the tensor cores'
  // sum cannot decide is summed again in the plain version's order.
  const int g = lane >> 2, t = lane & 3;
  const int ntiles = (HW + 15) / 16;
  float sums[C / 8][2];
#pragma unroll
  for (int j = 0; j < C / 8; ++j) sums[j][0] = sums[j][1] = 0.f;
  // this lane's ldmatrix row: row (lane & 15), 8-column half (lane >> 4)
  constexpr int kB = sizeof(bf16);
  const uint32_t brow1 = smem_u32(w1 + (lane & 15) * RS + (lane >> 4) * 8);
  const uint32_t brow2 = smem_u32(w2 + (lane & 15) * RS + (lane >> 4) * 8);
#pragma unroll 1
  for (int m0 = warp * MT; m0 < ntiles; m0 += kWarps * MT) {
    uint32_t arow[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m)
      arow[m] = smem_u32(ybuf + min((m0 + m) * 16 + (lane & 15), HW - 1) * RS + (lane >> 4) * 8);
    // sum-of-squares norms of this lane's two rows (g, g + 8) of each
    // tile, for the error bound of kExact
    float rn[MT][2];
    uint32_t a2[MT][KT][4];
#pragma unroll
    for (int nc = 0; nc < C / NC; ++nc) {
      float acc[MT][NC / 8][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
      if (nc == 0)
#pragma unroll
        for (int m = 0; m < MT; ++m) rn[m][0] = rn[m][1] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          ldmatrix_x4(a[m], arow[m] + kk * 16 * kB);
          if (G::kExact && nc == 0) {
            // registers 0 and 2 hold row g, 1 and 3 row g + 8
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float2 f = unpack2(a[m][r]);
              rn[m][r & 1] = fmaf(f.x, f.x, fmaf(f.y, f.y, rn[m][r & 1]));
            }
          }
        }
#pragma unroll
        for (int nn = 0; nn < NC / 16; ++nn) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, brow1 + (kk * 16 * RS + nc * NC + nn * 16) * kB);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_bf16(acc[m][2 * nn], a[m], b[0], b[1]);
            mma_bf16(acc[m][2 * nn + 1], a[m], b[2], b[3]);
          }
        }
      }
      if (G::kExact) {
        if (nc == 0) quad_norms<MT>(rn);
        settle<C, MT, NC / 8>(acc, rn, wnorm, b1, ybuf, w1, m0, nc * NC, HW, g, t, true);
      }
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int col = nc * NC + j * 8 + 2 * t;
        const float bx = b1[col], by = b1[col + 1];
        const int kt = (nc * NC + j * 8) / 16, half = j & 1;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          a2[m][kt][2 * half] = pack_bf16(fmaxf(acc[m][j][0] + bx, 0.f), fmaxf(acc[m][j][1] + by, 0.f));
          a2[m][kt][2 * half + 1] = pack_bf16(fmaxf(acc[m][j][2] + bx, 0.f), fmaxf(acc[m][j][3] + by, 0.f));
        }
      }
    }
    if (G::kExact) {
      // the relu output of these tiles replaces their depthwise rows,
      // for the sums settle() takes again in product 2; and its norms
      __syncwarp();
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        rn[m][0] = rn[m][1] = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = (m0 + m) * 16 + g + 8 * h;
#pragma unroll
          for (int kt = 0; kt < KT; ++kt)
#pragma unroll
            for (int r = h; r < 4; r += 2) {
              const float2 f = unpack2(a2[m][kt][r]);
              rn[m][h] = fmaf(f.x, f.x, fmaf(f.y, f.y, rn[m][h]));
              if (row < HW)
                *reinterpret_cast<uint32_t*>(ybuf + row * RS + kt * 16 + (r >> 1) * 8 + 2 * t) =
                    a2[m][kt][r];
            }
        }
      }
      quad_norms<MT>(rn);
      __syncwarp();
    }
#pragma unroll
    for (int nc = 0; nc < C / NC; ++nc) {
      float acc[MT][NC / 8][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
#pragma unroll
        for (int nn = 0; nn < NC / 16; ++nn) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, brow2 + (kk * 16 * RS + nc * NC + nn * 16) * kB);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_bf16(acc[m][2 * nn], a2[m][kk], b[0], b[1]);
            mma_bf16(acc[m][2 * nn + 1], a2[m][kk], b[2], b[3]);
          }
        }
      if (G::kExact)
        settle<C, MT, NC / 8>(acc, rn, wnorm + C, b2, ybuf, w2, m0, nc * NC, HW, g, t, false);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int col = nc * NC + j * 8 + 2 * t;
        const float bx = b2[col], by = b2[col + 1];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = (m0 + m) * 16 + g + 8 * h;
            if (row < HW) {
              bf2* xp = reinterpret_cast<bf2*>(act + row * RS + col);
              const float2 xo = __bfloat1622float2(*xp);
              const float y0 = round_bf16(acc[m][j][2 * h] + bx);
              const float y1 = round_bf16(acc[m][j][2 * h + 1] + by);
              const bf2 xr = __floats2bfloat162_rn(y0 + xo.x, y1 + xo.y);
              *xp = xr;
              const float2 xf = __bfloat1622float2(xr);
              sums[nc * NC / 8 + j][0] += xf.x;
              sums[nc * NC / 8 + j][1] += xf.y;
            }
          }
      }
    }
  }
  // sum over the 8 rows a warp's lanes hold (lanes of one t)
#pragma unroll
  for (int j = 0; j < C / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = sums[j][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (g == 0) red[warp * C + j * 8 + 2 * t + e] = v;
    }
}

// The SE gate after the mean z (bf16 values in f32, C of them, written by
// threads tid < C before the call): h1 = relu(z @ sw1 + sb1), gate =
// sigmoid(h1 @ sw2 + sb2), each rounded to bf16; red holds the per-warp
// partial sums ([2][kWarps][C]).
// twin: the "squeeze-excitation gate" block of convnext_trunk_kernel (which
// takes the mean z in the same block).
template <int C>
__device__ __forceinline__ void se_denses(const float* z, const uint4 (&s1)[Trunk<C>::SE_LOADS],
                                          const uint4 (&s2)[Trunk<C>::SE_LOADS], float sb1,
                                          float sb2, float* red, float* h1, float* gate,
                                          int tid) {
  float* red2 = red + kWarps * C;
  __syncthreads();
  dense_partial<C>(z, s1, red2, tid);
  __syncthreads();
  if (tid < C) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red2[w * C + tid];
    h1[tid] = round_bf16(fmaxf(a + sb1, 0.f));
  }
  __syncthreads();
  dense_partial<C>(h1, s2, red, tid);
  __syncthreads();
  if (tid < C) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += red[w * C + tid];
    gate[tid] = round_bf16(1.f / (1.f + expf(-(a + sb2))));
  }
  __syncthreads();
}

// Channel scale (bf16) of the HW cells of act, in place.
// twin: the "channel scale" block of convnext_trunk_kernel.
template <int C>
__device__ __forceinline__ void scale_channels(bf16* act, const float* gate, int HW, int tid) {
  constexpr int C8 = Trunk<C>::C8, RS = Trunk<C>::RS;
  for (int i = tid; i < HW * C8; i += kThreads) {
    const int c = i % C8;
    uint4* p = reinterpret_cast<uint4*>(act + (i / C8) * RS + c * 8);
    uint4 v = *p;
    bf2* h = reinterpret_cast<bf2*>(&v);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      h[q] = __floats2bfloat162_rn(f.x * gate[c * 8 + 2 * q], f.y * gate[c * 8 + 2 * q + 1]);
    }
    *p = v;
  }
}

// This layer's SE weights (16-byte chunks, in registers) and biases.
// twin: the "this layer's SE weights" block of convnext_trunk_kernel.
template <int C>
__device__ __forceinline__ void se_load(const Weights& wt, int l, uint4 (&s1)[Trunk<C>::SE_LOADS],
                                        uint4 (&s2)[Trunk<C>::SE_LOADS], float& sb1, float& sb2,
                                        int tid) {
  const uint4* g1 = reinterpret_cast<const uint4*>(wt.sw1 + size_t(l) * C * C);
  const uint4* g2 = reinterpret_cast<const uint4*>(wt.sw2 + size_t(l) * C * C);
#pragma unroll
  for (int k = 0; k < Trunk<C>::SE_LOADS; ++k) {
    s1[k] = __ldg(g1 + tid + k * kThreads);
    s2[k] = __ldg(g2 + tid + k * kThreads);
  }
  sb1 = tid < C ? __ldg(wt.sb1 + size_t(l) * C + tid) : 0.f;
  sb2 = tid < C ? __ldg(wt.sb2 + size_t(l) * C + tid) : 0.f;
}

// The one-CTA entry.  Its body stays written out as it was before the
// cluster entry came: the helpers above (column_norms, pointwise, se_load,
// se_denses, scale_channels) repeat its phases for the cluster entry, and
// calling them here too moves its register allocation (tools/sass_diff.py
// --source convnext_trunk.cu shows its SASS unchanged only so).
template <int C>
__global__ void __launch_bounds__(kThreads, Trunk<C>::kMinBlocks)
convnext_trunk_kernel(const bf16* __restrict__ x, Weights wt, bf16* __restrict__ out, int H,
                      int W, int L) {
  using G = Trunk<C>;
  constexpr int C2 = G::C2, C8 = G::C8, RS = G::RS, RS2 = G::RS2, KT = G::KT, MT = G::MT,
                NC = G::NC, SL = G::SE_LOADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int HW = H * W;
  const int board = blockIdx.x;

  bf16* act = reinterpret_cast<bf16*>(smem_raw);  // [HW][RS] activation
  bf16* ybuf = act + size_t(HW) * RS;             // [HW][RS] depthwise + BN
  bf16* w1 = ybuf + size_t(HW) * RS;              // [C][RS] (in, out)
  bf16* w2 = w1 + C * RS;
  bf16* dw = w2 + C * RS;                         // [49][C]
  float* vec = reinterpret_cast<float*>(dw + kTaps * C);  // bn_s, bn_t, b1, b2
  float* red = vec + 4 * C;                       // [2][kWarps][C] partial sums
  float* z = red + 2 * kWarps * C;
  float* h1 = z + C;
  float* gate = h1 + C;
  float* wnorm = gate + C;                        // [2][C] column norms of w1, w2
  const float* bn_s = vec;
  const float* bn_t = vec + C;
  const float* b1 = vec + 2 * C;
  const float* b2 = vec + 3 * C;

  {
    const bf16* src = x + size_t(board) * HW * C;
    for (int i = tid; i < HW * C8; i += kThreads)
      cp_async16(act + (i / C8) * RS + (i % C8) * 8, src + i * 8);
  }
  // >> staging
  stage_layer<C>(wt, 0, dw, w1, w2, vec, tid);
  // << staging
  cp_async_commit();

  for (int l = 0; l < L; ++l) {
    cp_async_wait_all();
    __syncthreads();

    // >> products
    // twin: column_norms()
    if (G::kExact) {
      for (int i = tid; i < 2 * C; i += kThreads) {
        const bf16* wc = (i < C ? w1 : w2) + i % C;
        float n = 0.f;
#pragma unroll 8
        for (int k = 0; k < C; ++k) {
          const float v = __bfloat162float(wc[k * RS]);
          n = fmaf(v, v, n);
        }
        wnorm[i] = kErr * sqrtf(n);
      }
    }
    // << products

    // >> depthwise
    if (W == kStrip)
      depthwise<C, true>(act, dw, ybuf, bn_s, bn_t, H, W, tid);
    else
      depthwise<C, false>(act, dw, ybuf, bn_s, bn_t, H, W, tid);
    // << depthwise
    __syncthreads();

    // >> products
    // pointwise on tensor cores: MT m16 tiles per warp through
    // relu(y @ w1 + b1) (bf16, kept as A fragments) and y2 = . @ w2 + b2
    // (bf16), residual add (bf16) in place, column sums for the SE mean.
    // With kExact, every output whose bf16 rounding the tensor cores'
    // sum cannot decide is summed again in the plain version's order.
    // twin: pointwise()
    {
      const int g = lane >> 2, t = lane & 3;
      const int ntiles = (HW + 15) / 16;
      float sums[C / 8][2];
#pragma unroll
      for (int j = 0; j < C / 8; ++j) sums[j][0] = sums[j][1] = 0.f;
      // this lane's ldmatrix row: row (lane & 15), 8-column half (lane >> 4)
      constexpr int kB = sizeof(bf16);
      const uint32_t brow1 = smem_u32(w1 + (lane & 15) * RS + (lane >> 4) * 8);
      const uint32_t brow2 = smem_u32(w2 + (lane & 15) * RS + (lane >> 4) * 8);
#pragma unroll 1
      for (int m0 = warp * MT; m0 < ntiles; m0 += kWarps * MT) {
        uint32_t arow[MT];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          arow[m] = smem_u32(ybuf + min((m0 + m) * 16 + (lane & 15), HW - 1) * RS + (lane >> 4) * 8);
        // sum-of-squares norms of this lane's two rows (g, g + 8) of each
        // tile, for the error bound of kExact
        float rn[MT][2];
        uint32_t a2[MT][KT][4];
#pragma unroll
        for (int nc = 0; nc < C / NC; ++nc) {
          float acc[MT][NC / 8][4];
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int j = 0; j < NC / 8; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
          if (nc == 0)
#pragma unroll
            for (int m = 0; m < MT; ++m) rn[m][0] = rn[m][1] = 0.f;
#pragma unroll
          for (int kk = 0; kk < KT; ++kk) {
            uint32_t a[MT][4];
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              ldmatrix_x4(a[m], arow[m] + kk * 16 * kB);
              if (G::kExact && nc == 0) {
                // registers 0 and 2 hold row g, 1 and 3 row g + 8
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                  const float2 f = unpack2(a[m][r]);
                  rn[m][r & 1] = fmaf(f.x, f.x, fmaf(f.y, f.y, rn[m][r & 1]));
                }
              }
            }
#pragma unroll
            for (int nn = 0; nn < NC / 16; ++nn) {
              uint32_t b[4];
              ldmatrix_x4_trans(b, brow1 + (kk * 16 * RS + nc * NC + nn * 16) * kB);
#pragma unroll
              for (int m = 0; m < MT; ++m) {
                mma_bf16(acc[m][2 * nn], a[m], b[0], b[1]);
                mma_bf16(acc[m][2 * nn + 1], a[m], b[2], b[3]);
              }
            }
          }
          if (G::kExact) {
            if (nc == 0) quad_norms<MT>(rn);
            settle<C, MT, NC / 8>(acc, rn, wnorm, b1, ybuf, w1, m0, nc * NC, HW, g, t, true);
          }
#pragma unroll
          for (int j = 0; j < NC / 8; ++j) {
            const int col = nc * NC + j * 8 + 2 * t;
            const float bx = b1[col], by = b1[col + 1];
            const int kt = (nc * NC + j * 8) / 16, half = j & 1;
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              a2[m][kt][2 * half] = pack_bf16(fmaxf(acc[m][j][0] + bx, 0.f), fmaxf(acc[m][j][1] + by, 0.f));
              a2[m][kt][2 * half + 1] = pack_bf16(fmaxf(acc[m][j][2] + bx, 0.f), fmaxf(acc[m][j][3] + by, 0.f));
            }
          }
        }
        if (G::kExact) {
          // the relu output of these tiles replaces their depthwise rows,
          // for the sums settle() takes again in product 2; and its norms
          __syncwarp();
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            rn[m][0] = rn[m][1] = 0.f;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = (m0 + m) * 16 + g + 8 * h;
#pragma unroll
              for (int kt = 0; kt < KT; ++kt)
#pragma unroll
                for (int r = h; r < 4; r += 2) {
                  const float2 f = unpack2(a2[m][kt][r]);
                  rn[m][h] = fmaf(f.x, f.x, fmaf(f.y, f.y, rn[m][h]));
                  if (row < HW)
                    *reinterpret_cast<uint32_t*>(ybuf + row * RS + kt * 16 + (r >> 1) * 8 + 2 * t) =
                        a2[m][kt][r];
                }
            }
          }
          quad_norms<MT>(rn);
          __syncwarp();
        }
#pragma unroll
        for (int nc = 0; nc < C / NC; ++nc) {
          float acc[MT][NC / 8][4];
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int j = 0; j < NC / 8; ++j) acc[m][j][0] = acc[m][j][1] = acc[m][j][2] = acc[m][j][3] = 0.f;
#pragma unroll
          for (int kk = 0; kk < KT; ++kk)
#pragma unroll
            for (int nn = 0; nn < NC / 16; ++nn) {
              uint32_t b[4];
              ldmatrix_x4_trans(b, brow2 + (kk * 16 * RS + nc * NC + nn * 16) * kB);
#pragma unroll
              for (int m = 0; m < MT; ++m) {
                mma_bf16(acc[m][2 * nn], a2[m][kk], b[0], b[1]);
                mma_bf16(acc[m][2 * nn + 1], a2[m][kk], b[2], b[3]);
              }
            }
          if (G::kExact)
            settle<C, MT, NC / 8>(acc, rn, wnorm + C, b2, ybuf, w2, m0, nc * NC, HW, g, t, false);
#pragma unroll
          for (int j = 0; j < NC / 8; ++j) {
            const int col = nc * NC + j * 8 + 2 * t;
            const float bx = b2[col], by = b2[col + 1];
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int row = (m0 + m) * 16 + g + 8 * h;
                if (row < HW) {
                  bf2* xp = reinterpret_cast<bf2*>(act + row * RS + col);
                  const float2 xo = __bfloat1622float2(*xp);
                  const float y0 = round_bf16(acc[m][j][2 * h] + bx);
                  const float y1 = round_bf16(acc[m][j][2 * h + 1] + by);
                  const bf2 xr = __floats2bfloat162_rn(y0 + xo.x, y1 + xo.y);
                  *xp = xr;
                  const float2 xf = __bfloat1622float2(xr);
                  sums[nc * NC / 8 + j][0] += xf.x;
                  sums[nc * NC / 8 + j][1] += xf.y;
                }
              }
          }
        }
      }
      // sum over the 8 rows a warp's lanes hold (lanes of one t)
#pragma unroll
      for (int j = 0; j < C / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = sums[j][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) red[warp * C + j * 8 + 2 * t + e] = v;
        }
    }
    // << products

    // >> se
    // this layer's SE weights and biases, in flight across the barrier
    // (twin: se_load())
    uint4 s1[SL], s2[SL];
    {
      const uint4* g1 = reinterpret_cast<const uint4*>(wt.sw1 + size_t(l) * C * C);
      const uint4* g2 = reinterpret_cast<const uint4*>(wt.sw2 + size_t(l) * C * C);
#pragma unroll
      for (int k = 0; k < SL; ++k) {
        s1[k] = __ldg(g1 + tid + k * kThreads);
        s2[k] = __ldg(g2 + tid + k * kThreads);
      }
    }
    const float sb1 = tid < C ? __ldg(wt.sb1 + size_t(l) * C + tid) : 0.f;
    const float sb2 = tid < C ? __ldg(wt.sb2 + size_t(l) * C + tid) : 0.f;
    // << se
    __syncthreads();

    // >> staging
    // the taps, w1, w2 and vectors of layer l are dead: fetch layer l+1's
    if (l + 1 < L) stage_layer<C>(wt, l + 1, dw, w1, w2, vec, tid);
    cp_async_commit();
    // << staging

    // >> se
    // squeeze-excitation gate (twin: se_denses(), after the mean)
    {
      float* red2 = red + kWarps * C;
      if (tid < C) {
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) a += red[w * C + tid];
        z[tid] = round_bf16(a / float(HW));
      }
      __syncthreads();
      dense_partial<C>(z, s1, red2, tid);
      __syncthreads();
      if (tid < C) {
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) a += red2[w * C + tid];
        h1[tid] = round_bf16(fmaxf(a + sb1, 0.f));
      }
      __syncthreads();
      dense_partial<C>(h1, s2, red, tid);
      __syncthreads();
      if (tid < C) {
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) a += red[w * C + tid];
        gate[tid] = round_bf16(1.f / (1.f + expf(-(a + sb2))));
      }
      __syncthreads();
    }
    // << se

    // >> scale
    // channel scale (bf16) in place; the next layer's first barrier orders
    // it before the depthwise (twin: scale_channels())
    for (int i = tid; i < HW * C8; i += kThreads) {
      const int c = i % C8;
      uint4* p = reinterpret_cast<uint4*>(act + (i / C8) * RS + c * 8);
      uint4 v = *p;
      bf2* h = reinterpret_cast<bf2*>(&v);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(h[q]);
        h[q] = __floats2bfloat162_rn(f.x * gate[c * 8 + 2 * q], f.y * gate[c * 8 + 2 * q + 1]);
      }
      *p = v;
    }
    // << scale
  }
  cp_async_wait_all();
  __syncthreads();

  {
    uint4* dst = reinterpret_cast<uint4*>(out + size_t(board) * HW * C);
    for (int i = tid; i < HW * C8; i += kThreads)
      dst[i] = *reinterpret_cast<const uint4*>(act + (i / C8) * RS + (i % C8) * 8);
  }
}

// The cluster entry: a cluster of two CTAs a board, CTA r (its rank in the
// cluster) holding rows [row0, row0 + rows) of the board, row0 = r * top,
// top = ceil(H / 2).  Shared memory: a window of rows + kR rows (CTA 0: its
// rows, then the kR halo rows below them; CTA 1: the kR halo rows above
// its rows, then its rows), the depthwise output of its rows, and the
// one-CTA kernel's weights and vectors, with `part`, its SE column sums.
// Both CTAs lay their buffers out alike (sized by the larger half), so an
// address in one maps to the same buffer in the other.
template <int C>
__global__ void __launch_bounds__(kThreads, 1)
convnext_trunk_cluster_kernel(const bf16* __restrict__ x, Weights wt, bf16* __restrict__ out,
                              int H, int W, int L) {
  using G = Trunk<C>;
  constexpr int C8 = G::C8, RS = G::RS, SL = G::SE_LOADS;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int rank = static_cast<int>(cluster.block_rank());
  const int board = blockIdx.x / 2;
  const int top = (H + 1) / 2;
  const int row0 = rank ? top : 0;
  const int rows = rank ? H - top : top;
  const int HWl = rows * W;                       // this CTA's cells

  bf16* win = reinterpret_cast<bf16*>(smem_raw);  // [(top + kR) * W][RS] window
  bf16* act = win + (rank ? kR * W * RS : 0);     // this CTA's rows
  bf16* halo = rank ? win : win + size_t(HWl) * RS;
  // the other CTA's rows next to this CTA's, at this offset of its window
  const size_t other = rank ? size_t(top - kR) * W * RS : size_t(kR) * W * RS;
  bf16* ybuf = win + size_t(top + kR) * W * RS;   // [top * W][RS] depthwise + BN
  bf16* w1 = ybuf + size_t(top) * W * RS;         // [C][RS] (in, out)
  bf16* w2 = w1 + C * RS;
  bf16* dw = w2 + C * RS;                         // [49][C]
  float* vec = reinterpret_cast<float*>(dw + kTaps * C);  // bn_s, bn_t, b1, b2
  float* red = vec + 4 * C;                       // [2][kWarps][C] partial sums
  float* z = red + 2 * kWarps * C;
  float* h1 = z + C;
  float* gate = h1 + C;
  float* wnorm = gate + C;                        // [2][C] column norms of w1, w2
  float* part = wnorm + 2 * C;                    // [C] this CTA's SE column sums
  const float* bn_s = vec;
  const float* bn_t = vec + C;
  const float* b1 = vec + 2 * C;
  const float* b2 = vec + 3 * C;

  {
    const bf16* src = x + (size_t(board) * H + row0) * W * C;
    for (int i = tid; i < HWl * C8; i += kThreads)
      cp_async16(act + (i / C8) * RS + (i % C8) * 8, src + i * 8);
  }
  // >> staging
  stage_layer<C>(wt, 0, dw, w1, w2, vec, tid);
  // << staging
  cp_async_commit();

  for (int l = 0; l < L; ++l) {
    cp_async_wait_all();
    // both CTAs' rows are this layer's input
    cluster.sync();
    {
      const bf16* src = cluster.map_shared_rank(win + other, rank ^ 1);
      for (int i = tid; i < kR * W * C8; i += kThreads) {
        const size_t o = size_t(i / C8) * RS + (i % C8) * 8;
        *reinterpret_cast<uint4*>(halo + o) = *reinterpret_cast<const uint4*>(src + o);
      }
    }
    // the halo is read before either CTA writes its rows in place
    cluster.sync();

    // >> products
    if (G::kExact) column_norms<C>(w1, w2, wnorm, tid);
    // << products

    // >> depthwise
    if (W == kStrip)
      depthwise<C, true, true>(win, dw, ybuf, bn_s, bn_t, rows, W, tid, rank ? kR : 0, rows + kR);
    else
      depthwise<C, false, true>(win, dw, ybuf, bn_s, bn_t, rows, W, tid, rank ? kR : 0, rows + kR);
    // << depthwise
    __syncthreads();

    // >> products
    pointwise<C>(act, ybuf, w1, w2, wnorm, b1, b2, red, HWl, warp, lane);
    // << products

    // >> se
    uint4 s1[SL], s2[SL];
    float sb1, sb2;
    se_load<C>(wt, l, s1, s2, sb1, sb2, tid);
    // << se
    __syncthreads();

    // >> staging
    if (l + 1 < L) stage_layer<C>(wt, l + 1, dw, w1, w2, vec, tid);
    cp_async_commit();
    // << staging

    // >> se
    // squeeze-excitation gate: the mean over the board of both CTAs' sums
    if (tid < C) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += red[w * C + tid];
      part[tid] = a;
    }
    cluster.sync();
    if (tid < C)
      z[tid] = round_bf16((cluster.map_shared_rank(part, 0)[tid] +
                           cluster.map_shared_rank(part, 1)[tid]) / float(H * W));
    se_denses<C>(z, s1, s2, sb1, sb2, red, h1, gate, tid);
    // << se

    // >> scale
    scale_channels<C>(act, gate, HWl, tid);
    // << scale
  }
  cp_async_wait_all();
  // no CTA leaves while the other may still read its shared memory
  cluster.sync();

  {
    uint4* dst = reinterpret_cast<uint4*>(out + (size_t(board) * H + row0) * W * C);
    for (int i = tid; i < HWl * C8; i += kThreads)
      dst[i] = *reinterpret_cast<const uint4*>(act + (i / C8) * RS + (i % C8) * 8);
  }
}

template <int C>
cudaError_t prepare(int H, int W, size_t* smem) {
  *smem = Trunk<C>::bytes(H, W);
  return cudaFuncSetAttribute(convnext_trunk_kernel<C>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <int C>
cudaError_t launch(int B, const void* x, const Weights& wt, void* out, int H, int W, int L,
                   void* stream) {
  size_t smem;
  cudaError_t err = prepare<C>(H, W, &smem);
  if (err != cudaSuccess) return err;
  convnext_trunk_kernel<C><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), wt, static_cast<bf16*>(out), H, W, L);
  return cudaGetLastError();
}

template <int C>
cudaError_t occupancy(int H, int W, int* info) {
  size_t smem;
  cudaError_t err = prepare<C>(H, W, &smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, convnext_trunk_kernel<C>);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], convnext_trunk_kernel<C>,
                                                      kThreads, smem);
  info[1] = attr.numRegs;
  info[2] = static_cast<int>(smem + attr.sharedSizeBytes);
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = 0;
  return err;
}

// the cluster entry's launch configuration (B boards, two CTAs each)
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int B, size_t smem, void* stream) {
    cfg.gridDim = dim3(2 * B);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = static_cast<cudaStream_t>(stream);
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <int C>
cudaError_t prepare_cluster(int H, int W, size_t* smem) {
  *smem = Trunk<C>::cluster_bytes(H, W);
  return cudaFuncSetAttribute(convnext_trunk_cluster_kernel<C>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <int C>
cudaError_t launch_cluster(int B, const void* x, const Weights& wt, void* out, int H, int W,
                           int L, void* stream) {
  size_t smem;
  cudaError_t err = prepare_cluster<C>(H, W, &smem);
  if (err != cudaSuccess) return err;
  ClusterLaunch cl(B, smem, stream);
  err = cudaLaunchKernelEx(&cl.cfg, convnext_trunk_cluster_kernel<C>,
                           static_cast<const bf16*>(x), wt, static_cast<bf16*>(out), H, W, L);
  if (err != cudaSuccess) return err;
  // a cluster launch the card refuses never runs: check it here
  return cudaGetLastError();
}

template <int C>
cudaError_t occupancy_cluster(int H, int W, int* info) {
  size_t smem;
  cudaError_t err = prepare_cluster<C>(H, W, &smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, convnext_trunk_cluster_kernel<C>);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], convnext_trunk_cluster_kernel<C>,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  info[1] = attr.numRegs;
  info[2] = static_cast<int>(smem + attr.sharedSizeBytes);
  info[3] = static_cast<int>(attr.localSizeBytes);
  ClusterLaunch cl(1, smem, nullptr);
  return cudaOccupancyMaxActiveClusters(&info[4], convnext_trunk_cluster_kernel<C>, &cl.cfg);
}

}  // namespace

namespace {

void set_weights(Weights* wt, const void* dw, const void* bn_s, const void* bn_t, const void* w1,
                 const void* b1, const void* w2, const void* b2, const void* sw1,
                 const void* sb1, const void* sw2, const void* sb2) {
  wt->dw = static_cast<const bf16*>(dw);
  wt->w1 = static_cast<const bf16*>(w1);
  wt->w2 = static_cast<const bf16*>(w2);
  wt->sw1 = static_cast<const bf16*>(sw1);
  wt->sw2 = static_cast<const bf16*>(sw2);
  wt->bn_s = static_cast<const float*>(bn_s);
  wt->bn_t = static_cast<const float*>(bn_t);
  wt->b1 = static_cast<const float*>(b1);
  wt->b2 = static_cast<const float*>(b2);
  wt->sb1 = static_cast<const float*>(sb1);
  wt->sb2 = static_cast<const float*>(sb2);
}

}  // namespace

// The one-CTA entry: a CTA a board, C = 64 or 128, where
// Trunk<C>::bytes(H, W) fits the card's opt-in shared memory.
extern "C" int ag_convnext_trunk(const void* x, const void* dw, const void* bn_s,
                                 const void* bn_t, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* sw1,
                                 const void* sb1, const void* sw2, const void* sb2,
                                 void* out, int B, int H, int W, int C, int L,
                                 void* stream) {
  if (C != 64 && C != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  Weights wt;
  set_weights(&wt, dw, bn_s, bn_t, w1, b1, w2, b2, sw1, sb1, sw2, sb2);
  if (C == 64) return static_cast<int>(launch<64>(B, x, wt, out, H, W, L, stream));
  return static_cast<int>(launch<128>(B, x, wt, out, H, W, L, stream));
}

// The cluster entry: two CTAs a board, C = 128, boards of at least
// 2 * kR rows (each half holds the halo the other reads).
extern "C" int ag_convnext_trunk_cluster(const void* x, const void* dw, const void* bn_s,
                                         const void* bn_t, const void* w1, const void* b1,
                                         const void* w2, const void* b2, const void* sw1,
                                         const void* sb1, const void* sw2, const void* sb2,
                                         void* out, int B, int H, int W, int C, int L,
                                         void* stream) {
  if (C != 128 || H < 2 * kR) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  Weights wt;
  set_weights(&wt, dw, bn_s, bn_t, w1, b1, w2, b2, sw1, sb1, sw2, sb2);
  return static_cast<int>(launch_cluster<128>(B, x, wt, out, H, W, L, stream));
}

// What an entry at width C on H x W boards gets from the card (`ctas` 1:
// the one-CTA entry, 2: the cluster entry): info[0] CTAs per SM, info[1]
// registers per thread, info[2] shared memory per CTA (bytes), info[3]
// local memory (spills) per thread (bytes), info[4] clusters the card
// holds at once (0 for the one-CTA entry).
extern "C" int ag_convnext_trunk_occupancy(int C, int H, int W, int ctas, int* info) {
  if (ctas == 2) {
    if (C != 128 || H < 2 * kR) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(occupancy_cluster<128>(H, W, info));
  }
  if (C == 64) return static_cast<int>(occupancy<64>(H, W, info));
  if (C == 128) return static_cast<int>(occupancy<128>(H, W, info));
  return static_cast<int>(cudaErrorInvalidValue);
}
