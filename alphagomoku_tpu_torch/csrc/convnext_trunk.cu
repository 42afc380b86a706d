// Fused ConvNext trunk for Hopper: all L blocks of the 64-filter trunk in
// one launch, each board's activation kept in shared memory throughout.
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
// What bounds it on the H100: operations.  At B = 1280, C = 64, L = 6 the
// trunk needs about 10.8 GFLOP of depthwise work (CUDA cores, f32) and
// about 28 GFLOP of pointwise and SE products (tensor-core eligible), but
// moves only about 74 MB of activation: the least time is about 0.19 ms,
// set by the depthwise at 67 TFLOP/s.
//
// Design (simple first): one CTA of 8 warps per board.  The zero-padded
// 21x21x64 bf16 activation (56 KB), the two pointwise intermediates
// (29 KB each) and one layer's weights (40 KB) live in shared memory, so
// the activation crosses HBM once in and once out for all L blocks.  A
// lane owns a pair of channels (bf16x2); the depthwise holds its 49 tap
// pairs in registers and a warp walks cells; the pointwise products run on
// CUDA cores with f32 accumulators, four cells per warp pass so that each
// weight pair read serves four cells; the SE reduction is done in-block.
// Tensor cores (mma/wgmma), TMA and multi-board tiles are left for later.
// C is fixed at 64: C = 128 would need more than the 227 KB of shared
// memory a block can have in this layout, and the wrapper rejects it.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kC = 64;            // channels
constexpr int kC2 = kC / 2;       // channel pairs == lanes of a warp
constexpr int kK = 7;             // depthwise kernel
constexpr int kR = kK / 2;        // its radius
constexpr int kTaps = kK * kK;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCellsPerPass = 4;  // cells per warp pass of the pointwise loop

using bf2 = __nv_bfloat162;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Smem {
  bf2* xpad;   // [(H+6)*(W+6)][kC2] zero-bordered activation
  bf2* ybuf;   // [HW][kC2] depthwise + BN output
  bf2* y1buf;  // [HW][kC2] first pointwise output
  bf2* dw;     // [49][kC2]
  bf2* w1;     // [kC][kC2]  (input channel, output channel pair)
  bf2* w2;
  bf2* sw1;
  bf2* sw2;
  float* vec;  // bn_s, bn_t, b1, b2, sb1, sb2: [6][kC]
  float* red;  // [kWarps][kC] partial channel sums
  float* se;   // z, h1, g: [3][kC]
};

inline size_t smem_bytes(int H, int W) {
  const size_t pad = size_t(H + 2 * kR) * (W + 2 * kR) * kC2;
  const size_t hw = size_t(H) * W * kC2;
  return (pad + 2 * hw + kTaps * kC2 + 4 * kC * kC2) * sizeof(bf2) +
         (6 * kC + kWarps * kC + 3 * kC) * sizeof(float);
}

__device__ inline Smem carve(unsigned char* base, int H, int W) {
  Smem s;
  bf2* p = reinterpret_cast<bf2*>(base);
  s.xpad = p;  p += size_t(H + 2 * kR) * (W + 2 * kR) * kC2;
  s.ybuf = p;  p += size_t(H) * W * kC2;
  s.y1buf = p; p += size_t(H) * W * kC2;
  s.dw = p;    p += kTaps * kC2;
  s.w1 = p;    p += kC * kC2;
  s.w2 = p;    p += kC * kC2;
  s.sw1 = p;   p += kC * kC2;
  s.sw2 = p;   p += kC * kC2;
  float* f = reinterpret_cast<float*>(p);
  s.vec = f;   f += 6 * kC;
  s.red = f;   f += kWarps * kC;
  s.se = f;
  return s;
}

struct Weights {
  const __nv_bfloat16 *dw, *w1, *w2, *sw1, *sw2;
  const float *bn_s, *bn_t, *b1, *b2, *sb1, *sb2;
};

// out[cell][co] = sum_ci in[cell][ci] * w[ci][co], one lane per output
// channel pair, kCellsPerPass cells per warp pass.  `epilogue(cell, acc0,
// acc1)` consumes the lane's two f32 sums.
template <typename Epilogue>
__device__ __forceinline__ void pointwise(const bf2* in, const bf2* w, int HW, int warp,
                                          int lane, Epilogue epilogue) {
  for (int g = warp * kCellsPerPass; g < HW; g += kWarps * kCellsPerPass) {
    float acc[kCellsPerPass][2];
#pragma unroll
    for (int j = 0; j < kCellsPerPass; ++j) acc[j][0] = acc[j][1] = 0.f;
#pragma unroll 4
    for (int ci2 = 0; ci2 < kC2; ++ci2) {
      const float2 wa = __bfloat1622float2(w[(2 * ci2) * kC2 + lane]);
      const float2 wb = __bfloat1622float2(w[(2 * ci2 + 1) * kC2 + lane]);
#pragma unroll
      for (int j = 0; j < kCellsPerPass; ++j) {
        const int cell = min(g + j, HW - 1);
        const float2 a = __bfloat1622float2(in[cell * kC2 + ci2]);
        acc[j][0] = fmaf(a.y, wb.x, fmaf(a.x, wa.x, acc[j][0]));
        acc[j][1] = fmaf(a.y, wb.y, fmaf(a.x, wa.y, acc[j][1]));
      }
    }
#pragma unroll
    for (int j = 0; j < kCellsPerPass; ++j) {
      if (g + j < HW) epilogue(g + j, acc[j][0], acc[j][1]);
    }
  }
}

// The SE dense layer for output channel `co`: sum_ci in[ci] * w[ci][co].
__device__ __forceinline__ float dense(const float* in, const bf2* w, int co) {
  const __nv_bfloat16* ws = reinterpret_cast<const __nv_bfloat16*>(w);
  float acc = 0.f;
#pragma unroll 8
  for (int ci = 0; ci < kC; ++ci) acc = fmaf(in[ci], __bfloat162float(ws[ci * kC + co]), acc);
  return acc;
}

__global__ void __launch_bounds__(kThreads, 1)
convnext_trunk_kernel(const __nv_bfloat16* __restrict__ x, Weights wt,
                      __nv_bfloat16* __restrict__ out, int H, int W, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem s = carve(smem_raw, H, W);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int HW = H * W;
  const int PW = W + 2 * kR;
  const int board = blockIdx.x;

  // load the board (16-byte vectors, 8 per cell) into the zero-bordered
  // activation buffer
  {
    const uint4* src = reinterpret_cast<const uint4*>(x + size_t(board) * HW * kC);
    uint4* dst = reinterpret_cast<uint4*>(s.xpad);
    const int padded = (H + 2 * kR) * PW;
    for (int i = tid; i < padded * (kC / 8); i += kThreads) {
      const int pc = i / (kC / 8), q = i % (kC / 8);
      const int r = pc / PW - kR, c = pc % PW - kR;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r >= 0 && r < H && c >= 0 && c < W) v = src[(r * W + c) * (kC / 8) + q];
      dst[i] = v;
    }
  }

  float* bn_s = s.vec;
  float* bn_t = s.vec + kC;
  float* b1 = s.vec + 2 * kC;
  float* b2 = s.vec + 3 * kC;
  float* sb1 = s.vec + 4 * kC;
  float* sb2 = s.vec + 5 * kC;
  float* z = s.se;
  float* h1 = s.se + kC;
  float* gate = s.se + 2 * kC;

  for (int l = 0; l < L; ++l) {
    // stage this layer's weights
    {
      const bf2* gdw = reinterpret_cast<const bf2*>(wt.dw + size_t(l) * kTaps * kC);
      for (int i = tid; i < kTaps * kC2; i += kThreads) s.dw[i] = gdw[i];
      const size_t mat = size_t(l) * kC * kC;
      const bf2* g1 = reinterpret_cast<const bf2*>(wt.w1 + mat);
      const bf2* g2 = reinterpret_cast<const bf2*>(wt.w2 + mat);
      const bf2* g3 = reinterpret_cast<const bf2*>(wt.sw1 + mat);
      const bf2* g4 = reinterpret_cast<const bf2*>(wt.sw2 + mat);
      for (int i = tid; i < kC * kC2; i += kThreads) {
        s.w1[i] = g1[i];
        s.w2[i] = g2[i];
        s.sw1[i] = g3[i];
        s.sw2[i] = g4[i];
      }
      for (int i = tid; i < kC; i += kThreads) {
        const size_t v = size_t(l) * kC + i;
        bn_s[i] = wt.bn_s[v];
        bn_t[i] = wt.bn_t[v];
        b1[i] = wt.b1[v];
        b2[i] = wt.b2[v];
        sb1[i] = wt.sb1[v];
        sb2[i] = wt.sb2[v];
      }
    }
    __syncthreads();

    // depthwise 7x7 + folded BN -> ybuf (bf16)
    {
      float2 taps[kTaps];
#pragma unroll
      for (int t = 0; t < kTaps; ++t) taps[t] = __bfloat1622float2(s.dw[t * kC2 + lane]);
      const float s0 = bn_s[2 * lane], s1 = bn_s[2 * lane + 1];
      const float t0 = bn_t[2 * lane], t1 = bn_t[2 * lane + 1];
      for (int cell = warp; cell < HW; cell += kWarps) {
        const int r = cell / W, c = cell % W;
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int di = 0; di < kK; ++di) {
#pragma unroll
          for (int dj = 0; dj < kK; ++dj) {
            const float2 v = __bfloat1622float2(s.xpad[((r + di) * PW + c + dj) * kC2 + lane]);
            a0 = fmaf(v.x, taps[di * kK + dj].x, a0);
            a1 = fmaf(v.y, taps[di * kK + dj].y, a1);
          }
        }
        s.ybuf[cell * kC2 + lane] = __floats2bfloat162_rn(a0 * s0 + t0, a1 * s1 + t1);
      }
    }
    __syncthreads();

    // pointwise expand: relu(y @ w1 + b1) -> y1buf (bf16)
    pointwise(s.ybuf, s.w1, HW, warp, lane, [&](int cell, float acc0, float acc1) {
      s.y1buf[cell * kC2 + lane] = __floats2bfloat162_rn(
          fmaxf(acc0 + b1[2 * lane], 0.f), fmaxf(acc1 + b1[2 * lane + 1], 0.f));
    });
    __syncthreads();

    // pointwise project + bias (bf16), residual add (bf16) in place, and
    // the per-channel sums of the result for the SE mean
    float sum0 = 0.f, sum1 = 0.f;
    pointwise(s.y1buf, s.w2, HW, warp, lane, [&](int cell, float acc0, float acc1) {
      const int r = cell / W, c = cell % W;
      bf2* xp = &s.xpad[((r + kR) * PW + c + kR) * kC2 + lane];
      const float2 xo = __bfloat1622float2(*xp);
      const float y0 = round_bf16(acc0 + b2[2 * lane]);
      const float y1 = round_bf16(acc1 + b2[2 * lane + 1]);
      const bf2 xr = __floats2bfloat162_rn(y0 + xo.x, y1 + xo.y);
      *xp = xr;
      const float2 xf = __bfloat1622float2(xr);
      sum0 += xf.x;
      sum1 += xf.y;
    });
    s.red[warp * kC + 2 * lane] = sum0;
    s.red[warp * kC + 2 * lane + 1] = sum1;
    __syncthreads();

    // squeeze-excitation gate
    if (tid < kC) {
      float acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) acc += s.red[w * kC + tid];
      z[tid] = round_bf16(acc / float(HW));
    }
    __syncthreads();
    if (tid < kC) h1[tid] = round_bf16(fmaxf(dense(z, s.sw1, tid) + sb1[tid], 0.f));
    __syncthreads();
    if (tid < kC) {
      const float a = dense(h1, s.sw2, tid) + sb2[tid];
      gate[tid] = round_bf16(1.f / (1.f + expf(-a)));
    }
    __syncthreads();

    // channel scale (bf16) in place
    for (int i = tid; i < HW * kC2; i += kThreads) {
      const int cell = i / kC2, p = i % kC2;
      const int r = cell / W, c = cell % W;
      bf2* xp = &s.xpad[((r + kR) * PW + c + kR) * kC2 + p];
      const float2 v = __bfloat1622float2(*xp);
      *xp = __floats2bfloat162_rn(v.x * gate[2 * p], v.y * gate[2 * p + 1]);
    }
    __syncthreads();
  }

  // store the board
  {
    uint4* dst = reinterpret_cast<uint4*>(out + size_t(board) * HW * kC);
    const uint4* src = reinterpret_cast<const uint4*>(s.xpad);
    for (int i = tid; i < HW * (kC / 8); i += kThreads) {
      const int cell = i / (kC / 8), q = i % (kC / 8);
      const int r = cell / W, c = cell % W;
      dst[i] = src[((r + kR) * PW + c + kR) * (kC / 8) + q];
    }
  }
}

}  // namespace

extern "C" int ag_convnext_trunk(const void* x, const void* dw, const void* bn_s,
                                 const void* bn_t, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* sw1,
                                 const void* sb1, const void* sw2, const void* sb2,
                                 void* out, int B, int H, int W, int C, int L,
                                 void* stream) {
  if (C != kC) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  const size_t smem = smem_bytes(H, W);
  cudaError_t err = cudaFuncSetAttribute(
      convnext_trunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Weights wt;
  wt.dw = static_cast<const __nv_bfloat16*>(dw);
  wt.w1 = static_cast<const __nv_bfloat16*>(w1);
  wt.w2 = static_cast<const __nv_bfloat16*>(w2);
  wt.sw1 = static_cast<const __nv_bfloat16*>(sw1);
  wt.sw2 = static_cast<const __nv_bfloat16*>(sw2);
  wt.bn_s = static_cast<const float*>(bn_s);
  wt.bn_t = static_cast<const float*>(bn_t);
  wt.b1 = static_cast<const float*>(b1);
  wt.b2 = static_cast<const float*>(b2);
  wt.sb1 = static_cast<const float*>(sb1);
  wt.sb2 = static_cast<const float*>(sb2);
  convnext_trunk_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), wt, static_cast<__nv_bfloat16*>(out), H, W, L);
  return static_cast<int>(cudaGetLastError());
}
