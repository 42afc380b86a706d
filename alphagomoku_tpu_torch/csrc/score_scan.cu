// Proven-score minimax backward scan of the MCTS backup, for Hopper.
//
// Replaces the Pallas TPU kernel `_kernel` of
// alphagomoku_tpu/ops/score_scan.py (wrapper `score_scan`, oracle
// `score_scan_reference`).  For each selection-path row the D levels are
// walked bottom-up; at each level the child's packed Score is inverted one
// ply up (`invert_up`) and written into the traversed edge slot if it is
// proven, then the node is re-minimaxed over its K edge scores: WIN if any
// active edge is WIN, LOSS/DRAW only when the node is complete and every
// active edge is proven.
//
// What bounds it on the H100: nothing but latency.  At the bench shape
// (R = 1280 rows, D = 16, K = 32) one call moves about 3.5 MB, about 1 us
// of HBM time, and does a few hundred integer operations per row.  The
// design keeps the whole scan in registers of one warp per row: lane k
// holds edge slot k, the level loop runs inside the warp, the slot read is
// a shuffle, the row max is __reduce_max_sync and "all proven" is
// __all_sync.  One launch replaces the D x ~10 small tensor kernels of the
// plain version.  K <= 32 (lanes >= K are masked); the wrapper rejects
// larger K.
//
// Scores are packed uint16 values carried zero-extended in int32, exactly
// as the port's tree stores them; masks are bytes (torch.bool).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 4;
// ProvenValue codes (search/score.py)
constexpr int kLoss = 0, kDraw = 1, kUnknown = 2, kWin = 3;

__device__ __forceinline__ bool is_inf(int s) { return s == 0 || s == 0xFFFF; }
__device__ __forceinline__ bool is_proven(int s) { return (s >> 13) != kUnknown && !is_inf(s); }
__device__ __forceinline__ bool is_win(int s) { return (s >> 13) == kWin && !is_inf(s); }

// score.make: ProvenValue << 13 | (4000 + eval), wrapped to 16 bits.
__device__ __forceinline__ int make(int pv, int ev) { return ((pv << 13) | (4000 + ev)) & 0xFFFF; }

// score.invert_up = increase_distance(neg(s), 1), step for step: negate
// (WIN <-> LOSS, eval sign flips except for DRAW; infinities swap), then
// push a finite result one ply further.
__device__ __forceinline__ int invert_up(int s) {
  if (is_inf(s)) return s == 0 ? 0xFFFF : 0;
  const int pv = s >> 13;
  const int ev = (s & 8191) - 4000;
  const int n = make(pv == kWin ? kLoss : (pv == kLoss ? kWin : pv), pv == kDraw ? ev : -ev);
  if (is_inf(n)) return n;
  const int npv = n >> 13;
  const int delta = (npv == kLoss || npv == kDraw) ? 1 : (npv == kWin ? -1 : 0);
  return make(npv, (n & 8191) - 4000 + delta);
}

__global__ void score_scan_kernel(const int32_t* __restrict__ start,
                                  const uint8_t* __restrict__ valid,
                                  const int32_t* __restrict__ sl,
                                  const int32_t* __restrict__ es,
                                  const uint8_t* __restrict__ ea,
                                  const uint8_t* __restrict__ comp,
                                  const int32_t* __restrict__ ns,
                                  int32_t* __restrict__ e_out,
                                  int32_t* __restrict__ ns_out,
                                  int R, int D, int K) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= R) return;  // uniform per warp
  const bool active = lane < K;
  int child = start[row];
  for (int d = D - 1; d >= 0; --d) {
    const int64_t rd = static_cast<int64_t>(row) * D + d;
    const bool vd = valid[rd] != 0;
    const int slot = sl[rd];
    const int es_k = active ? es[rd * K + lane] : 0;
    const bool ea_k = active && ea[rd * K + lane] != 0;

    const int pscore = invert_up(child);
    const bool in_range = slot >= 0 && slot < K;
    const int at_slot = __shfl_sync(kFull, es_k, in_range ? slot : 0);
    const int e_at_slot = in_range ? at_slot : 0;
    const int e_new = (vd && is_proven(pscore)) ? pscore : e_at_slot;
    const int row_k = lane == slot ? e_new : es_k;

    const int best = __reduce_max_sync(kFull, ea_k ? row_k : 0);
    const bool all_proven = __all_sync(kFull, !ea_k || is_proven(row_k));
    const bool provable = is_win(best) || (all_proven && comp[rd] != 0 && is_proven(best));
    const int ns_new = (vd && provable) ? best : ns[rd];
    child = vd ? ns_new : child;
    if (lane == 0) {
      e_out[rd] = e_new;
      ns_out[rd] = ns_new;
    }
  }
}

}  // namespace

extern "C" int ag_score_scan(const void* start, const void* valid, const void* sl,
                             const void* es, const void* ea, const void* comp,
                             const void* ns, void* e_out, void* ns_out, int R, int D,
                             int K, void* stream) {
  if (R <= 0 || D <= 0) return 0;
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  score_scan_kernel<<<blocks, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(start), static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(sl), static_cast<const int32_t*>(es),
      static_cast<const uint8_t*>(ea), static_cast<const uint8_t*>(comp),
      static_cast<const int32_t*>(ns), static_cast<int32_t*>(e_out),
      static_cast<int32_t*>(ns_out), R, D, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
