// Fused ConvNext trunk for Hopper: all L blocks of the trunk in one launch,
// each board's activation kept in shared memory throughout.  One kernel,
// templated on the width C and built for C = 64 (the 6x64 flagship) and
// C = 128 (the 8x128 network).
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
// C = 128) and about 4*H*W*C*C*B*L FLOP of pointwise and SE products that
// tensor cores could take (28 and 152 GFLOP).  The least time is set by
// the depthwise at 67 TFLOP/s: about 0.19 ms at C = 64 and 0.585 ms at
// C = 128.  The products run on CUDA cores here, where at C = 128 they are
// five times the depthwise's work: they, not the bound's depthwise, set
// this kernel's time.
//
// Layout: one CTA of 8 warps per board.  A block gets 227 KB of shared
// memory, and a zero-padded activation with both pointwise intermediates
// and four CxC matrices would need about 372 KB at C = 128.  So the
// activation is kept unpadded ([H*W][C] bf16, 57.6 KB at C = 128; the
// depthwise bounds-checks its taps), the depthwise + BN output has a
// second such buffer, and the relu output lives only as a tile of 5 cells
// per warp: a warp takes 5 cells through both pointwise products and
// writes the residual back into the activation in place, which is safe
// because a cell's product reads only the depthwise buffer.  Only w1 and
// w2 are staged; the SE dense layers read their weights from L2.  212 KB
// in all at C = 128, 90 KB at C = 64.  The depthwise gives each thread one
// channel pair and a strip of 5 cells of a row, so that each input read
// serves up to 7 taps; the pointwise gives each lane C/64 output channel
// pairs and reads 8 input channels per 16-byte load.
// Tensor cores (mma/wgmma), TMA and multi-board tiles are left for later.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kK = 7;             // depthwise kernel
constexpr int kR = kK / 2;        // its radius
constexpr int kTaps = kK * kK;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

using bf2 = __nv_bfloat162;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Weights {
  const __nv_bfloat16 *dw, *w1, *w2, *sw1, *sw2;
  const float *bn_s, *bn_t, *b1, *b2, *sb1, *sb2;
};

constexpr int kCells = 5;  // cells a warp takes through the pointwise at once
constexpr int kStrip = 5;  // depthwise output cells per thread pass (one row)

template <int C>
struct Trunk {
  static constexpr int C2 = C / 2;     // channel pairs
  static constexpr int C8 = C / 8;     // 16-byte vectors per cell
  static constexpr int PPL = C2 / 32;  // output pairs per lane in the pointwise
  static constexpr int kGroups = kThreads / C2;  // depthwise thread groups
  static_assert(C2 % 32 == 0 && kThreads % C2 == 0, "C must be a multiple of 64, at most 512");

  // dynamic shared memory of one CTA
  static size_t bytes(int H, int W) {
    const size_t hw = size_t(H) * W;
    return (2 * hw * C2 + size_t(kWarps) * kCells * C2 + kTaps * C2 + 2 * size_t(C) * C2) *
               sizeof(bf2) +
           (6 * C + kWarps * C + 3 * C) * sizeof(float);
  }
};

__device__ __forceinline__ void unpack8(const uint4& u, float* a) {
  const bf2* p = reinterpret_cast<const bf2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(p[i]);
    a[2 * i] = f.x;
    a[2 * i + 1] = f.y;
  }
}

// acc[j][2k..2k+1] = sum_ci in[cell j][ci] * w[ci][pair lane + 32k], for
// the kCells cells whose rows start at `in` (row stride C bf16; rows
// past `ncells` repeat the last valid row).
template <int C>
__device__ __forceinline__ void product(const bf2* in, int ncells, const bf2* w, int lane,
                                        float (&acc)[kCells][2 * Trunk<C>::PPL]) {
  constexpr int C2 = Trunk<C>::C2, C8 = Trunk<C>::C8, PPL = Trunk<C>::PPL;
#pragma unroll
  for (int j = 0; j < kCells; ++j)
#pragma unroll
    for (int k = 0; k < 2 * PPL; ++k) acc[j][k] = 0.f;
  const uint4* in4 = reinterpret_cast<const uint4*>(in);
#pragma unroll 1
  for (int c8 = 0; c8 < C8; ++c8) {
    float a[kCells][8];
#pragma unroll
    for (int j = 0; j < kCells; ++j) unpack8(in4[min(j, ncells - 1) * C8 + c8], a[j]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ci = c8 * 8 + i;
      float2 wv[PPL];
#pragma unroll
      for (int k = 0; k < PPL; ++k) wv[k] = __bfloat1622float2(w[ci * C2 + lane + 32 * k]);
#pragma unroll
      for (int j = 0; j < kCells; ++j)
#pragma unroll
        for (int k = 0; k < PPL; ++k) {
          acc[j][2 * k] = fmaf(a[j][i], wv[k].x, acc[j][2 * k]);
          acc[j][2 * k + 1] = fmaf(a[j][i], wv[k].y, acc[j][2 * k + 1]);
        }
    }
  }
}

// The SE dense layer for output channel `co`, its weights read from
// global memory (L2): sum_ci in[ci] * w[ci][co].
template <int C>
__device__ __forceinline__ float dense(const float* in, const __nv_bfloat16* w, int co) {
  float acc = 0.f;
#pragma unroll 8
  for (int ci = 0; ci < C; ++ci) acc = fmaf(in[ci], __bfloat162float(w[ci * C + co]), acc);
  return acc;
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
convnext_trunk_kernel(const __nv_bfloat16* __restrict__ x, Weights wt,
                      __nv_bfloat16* __restrict__ out, int H, int W, int L) {
  using G = Trunk<C>;
  constexpr int C2 = G::C2, C8 = G::C8, PPL = G::PPL;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int HW = H * W;
  const int board = blockIdx.x;

  bf2* act = reinterpret_cast<bf2*>(smem_raw);    // [HW][C2] activation
  bf2* ybuf = act + size_t(HW) * C2;              // [HW][C2] depthwise + BN
  bf2* tile = ybuf + size_t(HW) * C2;             // [kWarps][kCells][C2] relu
  bf2* dw = tile + kWarps * kCells * C2;      // [49][C2]
  bf2* w1 = dw + kTaps * C2;                      // [C][C2]
  bf2* w2 = w1 + C * C2;
  float* vec = reinterpret_cast<float*>(w2 + C * C2);  // bn_s, bn_t, b1, b2, sb1, sb2
  float* red = vec + 6 * C;                       // [kWarps][C]
  float* z = red + kWarps * C;
  float* h1 = z + C;
  float* gate = h1 + C;
  const float* bn_s = vec;
  const float* bn_t = vec + C;
  const float* b1 = vec + 2 * C;
  const float* b2 = vec + 3 * C;
  const float* sb1 = vec + 4 * C;
  const float* sb2 = vec + 5 * C;

  {
    const uint4* src = reinterpret_cast<const uint4*>(x + size_t(board) * HW * C);
    uint4* dst = reinterpret_cast<uint4*>(act);
    for (int i = tid; i < HW * C8; i += kThreads) dst[i] = src[i];
  }

  for (int l = 0; l < L; ++l) {
    // stage this layer's taps, pointwise weights and vectors
    {
      const uint4* gdw = reinterpret_cast<const uint4*>(wt.dw + size_t(l) * kTaps * C);
      for (int i = tid; i < kTaps * C8; i += kThreads) reinterpret_cast<uint4*>(dw)[i] = gdw[i];
      const size_t mat = size_t(l) * C * C;
      const uint4* g1 = reinterpret_cast<const uint4*>(wt.w1 + mat);
      const uint4* g2 = reinterpret_cast<const uint4*>(wt.w2 + mat);
      for (int i = tid; i < C * C8; i += kThreads) {
        reinterpret_cast<uint4*>(w1)[i] = g1[i];
        reinterpret_cast<uint4*>(w2)[i] = g2[i];
      }
      for (int i = tid; i < C; i += kThreads) {
        const size_t v = size_t(l) * C + i;
        vec[i] = wt.bn_s[v];
        vec[C + i] = wt.bn_t[v];
        vec[2 * C + i] = wt.b1[v];
        vec[3 * C + i] = wt.b2[v];
        vec[4 * C + i] = wt.sb1[v];
        vec[5 * C + i] = wt.sb2[v];
      }
    }
    __syncthreads();

    // depthwise 7x7 + folded BN -> ybuf (bf16): thread = (pair p, group g),
    // a strip of kStrip cells of one row per pass
    {
      const int p = tid % C2, g = tid / C2;
      float2 taps[kTaps];
#pragma unroll
      for (int t = 0; t < kTaps; ++t) taps[t] = __bfloat1622float2(dw[t * C2 + p]);
      const float s0 = bn_s[2 * p], s1 = bn_s[2 * p + 1];
      const float t0 = bn_t[2 * p], t1 = bn_t[2 * p + 1];
      const int per_row = (W + kStrip - 1) / kStrip;
      for (int s = g; s < H * per_row; s += G::kGroups) {
        const int r = s / per_row, c0 = (s % per_row) * kStrip;
        float2 acc[kStrip];
#pragma unroll
        for (int o = 0; o < kStrip; ++o) acc[o] = make_float2(0.f, 0.f);
#pragma unroll
        for (int di = 0; di < kK; ++di) {
          const int rr = r + di - kR;
          if (rr < 0 || rr >= H) continue;
          float2 v[kStrip + kK - 1];
#pragma unroll
          for (int j = 0; j < kStrip + kK - 1; ++j) {
            const int cc = c0 + j - kR;
            v[j] = (cc >= 0 && cc < W) ? __bfloat1622float2(act[(rr * W + cc) * C2 + p])
                                       : make_float2(0.f, 0.f);
          }
#pragma unroll
          for (int o = 0; o < kStrip; ++o)
#pragma unroll
            for (int dj = 0; dj < kK; ++dj) {
              acc[o].x = fmaf(v[o + dj].x, taps[di * kK + dj].x, acc[o].x);
              acc[o].y = fmaf(v[o + dj].y, taps[di * kK + dj].y, acc[o].y);
            }
        }
#pragma unroll
        for (int o = 0; o < kStrip; ++o) {
          if (c0 + o < W)
            ybuf[(r * W + c0 + o) * C2 + p] =
                __floats2bfloat162_rn(acc[o].x * s0 + t0, acc[o].y * s1 + t1);
        }
      }
    }
    __syncthreads();

    // pointwise, warp-local: kCells cells at a time through
    // relu(y @ w1 + b1) -> tile (bf16) and then y2 = tile @ w2 + b2 (bf16),
    // residual add (bf16) in place, and the channel sums for the SE mean
    {
      bf2* mine = tile + warp * kCells * C2;
      float sum[2 * PPL];
#pragma unroll
      for (int k = 0; k < 2 * PPL; ++k) sum[k] = 0.f;
      float acc[kCells][2 * PPL];
      for (int cell0 = warp * kCells; cell0 < HW; cell0 += kWarps * kCells) {
        const int n = min(kCells, HW - cell0);
        product<C>(ybuf + cell0 * C2, n, w1, lane, acc);
#pragma unroll
        for (int j = 0; j < kCells; ++j)
#pragma unroll
          for (int k = 0; k < PPL; ++k) {
            const int pr = lane + 32 * k;
            mine[j * C2 + pr] = __floats2bfloat162_rn(fmaxf(acc[j][2 * k] + b1[2 * pr], 0.f),
                                                      fmaxf(acc[j][2 * k + 1] + b1[2 * pr + 1], 0.f));
          }
        __syncwarp();
        product<C>(mine, n, w2, lane, acc);
#pragma unroll
        for (int j = 0; j < kCells; ++j) {
          if (j >= n) break;
#pragma unroll
          for (int k = 0; k < PPL; ++k) {
            const int pr = lane + 32 * k;
            bf2* xp = &act[(cell0 + j) * C2 + pr];
            const float2 xo = __bfloat1622float2(*xp);
            const float y0 = round_bf16(acc[j][2 * k] + b2[2 * pr]);
            const float y1 = round_bf16(acc[j][2 * k + 1] + b2[2 * pr + 1]);
            const bf2 xr = __floats2bfloat162_rn(y0 + xo.x, y1 + xo.y);
            *xp = xr;
            const float2 xf = __bfloat1622float2(xr);
            sum[2 * k] += xf.x;
            sum[2 * k + 1] += xf.y;
          }
        }
        __syncwarp();
      }
#pragma unroll
      for (int k = 0; k < PPL; ++k) {
        red[warp * C + 2 * (lane + 32 * k)] = sum[2 * k];
        red[warp * C + 2 * (lane + 32 * k) + 1] = sum[2 * k + 1];
      }
    }
    __syncthreads();

    // squeeze-excitation gate
    const __nv_bfloat16* gsw1 = wt.sw1 + size_t(l) * C * C;
    const __nv_bfloat16* gsw2 = wt.sw2 + size_t(l) * C * C;
    if (tid < C) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += red[w * C + tid];
      z[tid] = round_bf16(a / float(HW));
    }
    __syncthreads();
    if (tid < C) h1[tid] = round_bf16(fmaxf(dense<C>(z, gsw1, tid) + sb1[tid], 0.f));
    __syncthreads();
    if (tid < C) {
      const float a = dense<C>(h1, gsw2, tid) + sb2[tid];
      gate[tid] = round_bf16(1.f / (1.f + expf(-a)));
    }
    __syncthreads();

    // channel scale (bf16) in place
    for (int i = tid; i < HW * C2; i += kThreads) {
      const int p = i % C2;
      const float2 v = __bfloat1622float2(act[i]);
      act[i] = __floats2bfloat162_rn(v.x * gate[2 * p], v.y * gate[2 * p + 1]);
    }
    __syncthreads();
  }

  {
    uint4* dst = reinterpret_cast<uint4*>(out + size_t(board) * HW * C);
    const uint4* src = reinterpret_cast<const uint4*>(act);
    for (int i = tid; i < HW * C8; i += kThreads) dst[i] = src[i];
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int B, const void* x, const Weights& wt, void* out,
                   int H, int W, int L, void* stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), wt, static_cast<__nv_bfloat16*>(out), H, W, L);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ag_convnext_trunk(const void* x, const void* dw, const void* bn_s,
                                 const void* bn_t, const void* w1, const void* b1,
                                 const void* w2, const void* b2, const void* sw1,
                                 const void* sb1, const void* sw2, const void* sb2,
                                 void* out, int B, int H, int W, int C, int L,
                                 void* stream) {
  if (C != 64 && C != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
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
  if (C == 64)
    return static_cast<int>(launch(convnext_trunk_kernel<64>, Trunk<64>::bytes(H, W), B, x, wt,
                                   out, H, W, L, stream));
  return static_cast<int>(launch(convnext_trunk_kernel<128>, Trunk<128>::bytes(H, W), B, x, wt,
                                 out, H, W, L, stream));
}
