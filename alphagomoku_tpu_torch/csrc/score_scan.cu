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
// Two entry points share one scan core (`scan_levels`):
// - `ag_score_scan` takes the path's rows gathered into [R, D(, K)] arrays,
//   the Pallas kernel's interface;
// - `ag_score_backup` is the whole proven-score backup of one simulation
//   step: per board it reads the path `pn`/`ps` and then the path's edge
//   and node rows where they lie in the tree, scans, and writes the new
//   edge and node scores back into the tree in place.  The JAX package
//   gathers the rows with one-hot einsums and writes back through dedup and
//   one-hot deltas, because the TPU cannot gather or scatter per row; a
//   warp here reads and writes its own board's rows.  Direct writes equal
//   the plain version's `index_put_` of new minus old because a path
//   visits a node at most once and each board has one path.
//
// What bounds it on the H100: not bytes.  At the bench shape (1280 rows,
// D = 16, K = 32) score_scan moves 2.2 MB at the interface's u16 scores
// (0.64 us of HBM time), less than a launch of the same grid that only
// loads and stores a word a row takes.  The rest is the issue of each
// row's per-level integer work and the latency of its dependent chain
// (PERF.md has the split, from tools/scan_phases.py).  The first design loaded
// each level's inputs after the previous level's result, 16 memory round
// trips in a chain.  This design splits a row's work into four stages so
// that the only dependent chain left is integer arithmetic on registers,
// one invert_up and a select per level:
//   1. loads: every level's inputs of the chunk at once, as predicated
//      loads (no branch between them), so the warp waits for one memory
//      latency (two for score_backup: the path's indices, then the rows
//      they name); lane k holds edge slot k of every level in `es[d]`,
//      lane d holds level d's scalars;
//   2. per level, all that does not depend on the child's score, through
//      warp collectives (a shuffle, a ballot, __reduce_max_sync,
//      __all_sync): the traversed slot's score, the max and "all proven"
//      of the other active slots; from them the level's candidate new
//      node scores (see scan_levels) and their invert_up;
//   3. the chain, bottom-up, on registers: p = invert_up(child) carried
//      from level to level, beside a few compares that pick the next p;
//   4. stores: lane d writes level d's results, after every read.
// The depth is a template bound (kD = 16 or 32 levels a chunk, every loop
// fully unrolled), so the arrays indexed by the level stay in registers;
// deeper paths run in chunks of 32 levels, deepest first.  Registers, not
// a TMA staging buffer, hold the rows: a lane holds one edge score a level
// and the rows are consumed by stage 2 before the chain starts, so a
// shared-memory stage would add a barrier round trip without removing a
// latency.  score_backup runs stages 1b-3 over the levels up to the path's
// deepest valid one only (kL = 4, 8, 16 or 32, picked per warp): the
// search's paths are a few levels deep.  `ag_score_scan_occupancy` reports
// what the card gives each instantiation (spills must be 0).
//
// One warp per row, kWarps rows per block.  K <= 32 (lanes >= K are
// inactive) takes the staged kernels above.  K > 32 takes the wide kernels
// (`score_scan_wide_kernel`, `score_backup_wide_kernel`): lane l holds the
// slots l, l + 32, l + 64, ... of a level and reduces them itself (the max
// over active slots, "all proven or inactive"), a warp reduction finishes
// the row, and the levels run one after another, each loading its row after
// the previous level's result.  They are the simple design, not a tuned one
// (ROADMAP.md §2).  Scores are packed uint16 values carried zero-extended in
// int32, exactly as the port's tree stores them; masks are bytes
// (torch.bool).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNull = -1;  // empty edge slot, empty path level
constexpr int kWarps = 4;  // path rows per block, one warp each
// ProvenValue codes (search/score.py), and the same in the packed bits
constexpr int kLoss = 0, kDraw = 1, kUnknown = 2, kWin = 3;
constexpr int kLossBits = kLoss << 13, kDrawBits = kDraw << 13, kWinBits = kWin << 13;
// level flags of stage 2
constexpr int kValid = 1, kSlotActive = 2, kOthersComplete = 4;

// Predicates combine with & and |, never && and ||: short-circuit forms
// let the compiler branch inside the chain.
__device__ __forceinline__ bool is_inf(int s) { return (s == 0) | (s == 0xFFFF); }
__device__ __forceinline__ bool is_proven(int s) { return ((s >> 13) != kUnknown) & !is_inf(s); }
__device__ __forceinline__ bool is_win(int s) { return ((s >> 13) == kWin) & !is_inf(s); }

// score.invert_up = increase_distance(neg(s), 1), on the packed bits:
// negate (LOSS <-> WIN; the eval field e of a non-DRAW score becomes
// 8000 - e; infinities swap), then push a finite result one ply further
// (a LOSS or DRAW field + 1, a WIN field - 1), each step wrapped to 16 bits
// as score.make wraps.  Every case is computed and then selected: this is
// the scan's dependent chain.
__device__ __forceinline__ int invert_up(int s) {
  const int hi = s & 0xE000;
  const int flip = ((hi == kLossBits) | (hi == kWinBits)) ? (kLossBits ^ kWinBits) : 0;
  const int n = hi == kDrawBits ? s : ((hi ^ flip) | (8000 - (s & 8191))) & 0xFFFF;
  const int n_hi = n & 0xE000;
  const int delta = n_hi <= kDrawBits ? 1 : n_hi == kWinBits ? -1 : 0;
  const int up = is_inf(n) ? n : (n_hi | ((n & 8191) + delta)) & 0xFFFF;
  return is_inf(s) ? s ^ 0xFFFF : up;
}

// Loads that read nothing where `pred` is false and give 0 there, written
// as predicated PTX so that the compiler puts no branch between them and
// issues every load of a chunk before the first use.
__device__ __forceinline__ int ld_or_zero(const int32_t* p, bool pred) {
  int v;
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\tmov.b32 %0, 0;\n\t"
      "@q ld.global.b32 %0, [%1];\n\t}"
      : "=r"(v)
      : "l"(p), "r"(static_cast<unsigned>(pred)));
  return v;
}
__device__ __forceinline__ bool ld_byte_or_false(const uint8_t* p, bool pred) {
  unsigned v;
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\tmov.b32 %0, 0;\n\t"
      "@q ld.global.u8 %0, [%1];\n\t}"
      : "=r"(v)
      : "l"(p), "r"(static_cast<unsigned>(pred)));
  return v != 0;
}
__device__ __forceinline__ int64_t ld_or_null(const int64_t* p, bool pred) {
  int64_t v;
  asm volatile(
      "{\n\t.reg .pred q;\n\tsetp.ne.u32 q, %2, 0;\n\tmov.b64 %0, -1;\n\t"
      "@q ld.global.b64 %0, [%1];\n\t}"
      : "=l"(v)
      : "l"(p), "r"(static_cast<unsigned>(pred)));
  return v;
}

// Level `lane` of the chunk, as lane `lane` loaded it.
struct LaneLevel {
  bool valid;
  bool complete;
  int slot;  // the traversed edge slot
  int ns;    // the node's stored score
};

// Stages 2 and 3 for the lowest kL levels of a chunk of kD levels; every
// level from kL up is invalid.  Lane k holds edge slot k's score of level
// d in es[d] and its activity in bit d of ea_bits (0 for lanes >= K and for
// levels past the chunk); lane d holds level d's scalars in `mine` (valid
// = false past the chunk).  p is invert_up of the child's score entering
// the chunk; returns it on leaving the chunk.  Lane d < kL gets level d's
// new edge score and node score in e_mine and ns_mine.
//
// With "others" the level's active slots other than the traversed one, a
// valid level's new node score is one of:
//   U      if p is unproven (the slot keeps its score), a constant;
//   P      if p is proven but the slot is inactive or p no higher than
//          the others' max, a constant;
//   p      if p is proven, the slot active, p above the others' max, and
//          p wins or every other slot is proven in a complete node;
//   the old node score otherwise.
// Stage 2 computes U and P of every level and the invert_up of all three
// constants, so that the chain only computes invert_up(p) and picks.
template <int kD, int kL>
__device__ __forceinline__ int scan_levels(int p, const int (&es)[kD], unsigned ea_bits,
                                           const LaneLevel& mine, int K, int lane, int& e_mine,
                                           int& ns_mine) {
  const int slot_mine = mine.slot >= 0 && mine.slot < K ? mine.slot : -1;  // -1: out of range
  // stage 2: the level's row seen through warp collectives; lane d keeps
  // level d's values
  int at_slot = 0, best_others = 0;
  bool slot_active = false, others_proven = false;
#pragma unroll
  for (int d = 0; d < kL; ++d) {
    const int slot = __shfl_sync(kFull, slot_mine, d);
    const bool ea_k = (ea_bits >> d) & 1u;
    const int at = __shfl_sync(kFull, es[d], slot < 0 ? 0 : slot);
    const unsigned ea_row = __ballot_sync(kFull, ea_k);
    const bool other = ea_k && lane != slot;
    const int best = __reduce_max_sync(kFull, other ? es[d] : 0);
    const bool proven = __all_sync(kFull, !other || is_proven(es[d]));
    if (lane == d) {
      at_slot = slot < 0 ? 0 : at;
      best_others = best;
      slot_active = slot >= 0 && ((ea_row >> slot) & 1u);
      others_proven = proven;
    }
  }
  // each lane for its own level: the constants U and P, and what the chain
  // needs of the level
  const bool others_complete = others_proven && mine.complete;
  const int best_u = max(best_others, slot_active ? at_slot : 0);
  const bool all_proven_u = others_proven && (!slot_active || is_proven(at_slot));
  const int u = (is_win(best_u) || (all_proven_u && mine.complete && is_proven(best_u)))
                    ? best_u : mine.ns;
  const int p_const = (is_win(best_others) || (others_complete && is_proven(best_others)))
                          ? best_others : mine.ns;
  const int flags = (mine.valid ? kValid : 0) | (slot_active ? kSlotActive : 0) |
                    (others_complete ? kOthersComplete : 0);
  const int inv_u_mine = invert_up(u), inv_p_mine = invert_up(p_const);
  const int inv_old_mine = invert_up(mine.ns);
  int f[kL], best_d[kL], inv_u[kL], inv_p[kL], inv_old[kL];
#pragma unroll
  for (int d = 0; d < kL; ++d) {
    f[d] = __shfl_sync(kFull, flags, d);
    best_d[d] = __shfl_sync(kFull, best_others, d);
    inv_u[d] = __shfl_sync(kFull, inv_u_mine, d);
    inv_p[d] = __shfl_sync(kFull, inv_p_mine, d);
    inv_old[d] = __shfl_sync(kFull, inv_old_mine, d);
  }
  // stage 3: the chain, deepest level first
  int seen = 0;
#pragma unroll
  for (int d = kL - 1; d >= 0; --d) {
    // >> chain
    const int q = invert_up(p);
    const bool proven = is_proven(p);
    const bool above = ((f[d] & kSlotActive) != 0) & (p > best_d[d]);
    const bool take = is_win(p) | ((f[d] & kOthersComplete) != 0);
    const bool valid = (f[d] & kValid) != 0;
    const int constant = proven ? (above ? inv_old[d] : inv_p[d]) : inv_u[d];
    const int other = valid ? constant : p;
    if (lane == d) seen = p;
    p = (valid & proven & above & take) ? q : other;
    // << chain
  }
  // each lane for its own level: the new scores from the p it saw
  const bool proven = is_proven(seen);
  const bool above = slot_active & (seen > best_others);
  const bool take = is_win(seen) | others_complete;
  e_mine = (mine.valid & proven) ? seen : at_slot;
  ns_mine = !mine.valid ? mine.ns : !proven ? u : !above ? p_const : take ? seen : mine.ns;
  return p;
}

// score_scan: the Pallas kernel's interface, one row per warp.
template <int kD>
__global__ void __launch_bounds__(kWarps * 32) score_scan_kernel(
    const int32_t* __restrict__ start, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ sl, const int32_t* __restrict__ es,
    const uint8_t* __restrict__ ea, const uint8_t* __restrict__ comp,
    const int32_t* __restrict__ ns, int32_t* __restrict__ e_out,
    int32_t* __restrict__ ns_out, int R, int D, int K) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;  // uniform per warp; a warp's collectives meet only its own lanes
  const int lane = threadIdx.x & 31;
  const bool active = lane < K;
  int p = invert_up(start[row]);
  for (int lo = (D - 1) / kD * kD; lo >= 0; lo -= kD) {
    const int n = min(kD, D - lo);
    const int64_t base = row * D + lo;  // level lo of this row
    // stage 1: every load of the chunk
    const bool mine_in = lane < n;
    const LaneLevel mine{ld_byte_or_false(valid + base + lane, mine_in),
                         ld_byte_or_false(comp + base + lane, mine_in),
                         ld_or_zero(sl + base + lane, mine_in),
                         ld_or_zero(ns + base + lane, mine_in)};
    const int32_t* es_lane = es + base * K + lane;
    const uint8_t* ea_lane = ea + base * K + lane;
    int es_d[kD];
    unsigned ea_bits = 0;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      const bool ld = d < n && active;
      es_d[d] = ld_or_zero(es_lane + d * K, ld);
      ea_bits |= ld_byte_or_false(ea_lane + d * K, ld) ? 1u << d : 0u;
    }
    int e_mine = 0, ns_mine = 0;
    p = scan_levels<kD, kD>(p, es_d, ea_bits, mine, K, lane, e_mine, ns_mine);
    // stage 4
    if (mine_in) {
      e_out[base + lane] = e_mine;
      ns_out[base + lane] = ns_mine;
    }
  }
}

// score_backup's stages 1b to 4 for the lowest kL levels of a chunk, all
// of the path's valid levels there: read the rows the path names, scan,
// write the new scores into the tree.
template <int kD, int kL>
__device__ __forceinline__ int backup_levels(int p, int32_t* edge_score,
                                             const int32_t* __restrict__ edge_action,
                                             const uint8_t* __restrict__ node_complete,
                                             int32_t* node_score, int64_t tree, bool valid,
                                             unsigned valid_row, int node, int slot, int K,
                                             int lane) {
  const LaneLevel mine{valid, ld_byte_or_false(node_complete + tree + node, valid), slot,
                       ld_or_zero(node_score + tree + node, valid)};
  int es_d[kD];
  unsigned ea_bits = 0;
#pragma unroll
  for (int d = 0; d < kL; ++d) {
    const int nd = __shfl_sync(kFull, node, d);
    const bool ld = ((valid_row >> d) & 1u) && lane < K;
    const int64_t at = (tree + nd) * K + lane;
    es_d[d] = ld_or_zero(edge_score + at, ld);
    const int action = ld_or_zero(edge_action + at, ld);
    ea_bits |= ld && action != kNull ? 1u << d : 0u;
  }
  int e_mine = 0, ns_mine = 0;
  p = scan_levels<kD, kL>(p, es_d, ea_bits, mine, K, lane, e_mine, ns_mine);
  // stage 4: after every read of this chunk (stage 2's collectives consumed
  // them all); a deeper chunk's writes precede a shallower chunk's reads,
  // which touch other nodes since a path visits a node at most once
  __syncwarp();
  if (valid) {
    edge_score[(tree + node) * K + slot] = e_mine;
    node_score[tree + node] = ns_mine;
  }
  return p;
}

// score_backup: one board's path per warp, read from and written to the
// tree in place.  pn, ps [B, D] int64 (kNull past the path); edge_score,
// edge_action [B, N, K] int32; node_complete [B, N] bool; node_score
// [B, N] int32; start [B] int32.  Levels whose pn is kNull read and write
// nothing (the scan passes the child through them).  An index outside the
// tree traps (the plain version raises there).
template <int kD>
__global__ void __launch_bounds__(kWarps * 32) score_backup_kernel(
    int32_t* edge_score, const int32_t* __restrict__ edge_action,
    const uint8_t* __restrict__ node_complete, int32_t* node_score,
    const int64_t* __restrict__ pn, const int64_t* __restrict__ ps,
    const int32_t* __restrict__ start, int B, int N, int D, int K) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // uniform per warp; a warp's collectives meet only its own lanes
  const int lane = threadIdx.x & 31;
  const int64_t tree = b * N;  // node 0 of this board
  int p = invert_up(start[b]);
  for (int lo = (D - 1) / kD * kD; lo >= 0; lo -= kD) {
    const int n = min(kD, D - lo);
    // stage 1a: the path's indices, lane d for level lo + d
    const int64_t node64 = ld_or_null(pn + b * D + lo + lane, lane < n);
    const int64_t slot64 = ld_or_null(ps + b * D + lo + lane, lane < n);
    const bool valid = node64 != kNull;
    if (valid && (node64 < 0 || node64 >= N || slot64 < 0 || slot64 >= K)) __trap();
    const int node = valid ? static_cast<int>(node64) : 0;
    const int slot = valid ? static_cast<int>(slot64) : 0;
    const unsigned valid_row = __ballot_sync(kFull, valid);
    // the rest over the levels up to the deepest valid one (uniform)
    const int top = 31 - __clz(valid_row);
#define AG_BACKUP_LEVELS(kL)                                                                   \
  backup_levels<kD, kL>(p, edge_score, edge_action, node_complete, node_score, tree, valid,  \
                        valid_row, node, slot, K, lane)
    if (top < 4) {
      p = AG_BACKUP_LEVELS(4);
    } else if (top < 8) {
      p = AG_BACKUP_LEVELS(8);
    } else if (kD > 16 && top < 16) {
      p = AG_BACKUP_LEVELS((kD > 16 ? 16 : kD));
    } else {
      p = AG_BACKUP_LEVELS(kD);
    }
#undef AG_BACKUP_LEVELS
  }
}

// One level of the wide scan, for K > 32: `p` = invert_up of the child's
// score (uniform), `row` the level's K edge scores and `act` their activity
// (act(k) false for an inactive slot), `slot` the traversed slot (out of
// [0, K): none), `valid`/`complete`/`ns` the level's scalars.  Returns the
// new node score; `e_new` gets the new edge score of the slot.  Uniform
// across the warp.
template <typename Row, typename Act>
__device__ __forceinline__ int wide_level(int p, Row row, Act act, int slot, bool valid,
                                          bool complete, int ns, int K, int lane,
                                          int& e_new) {
  const bool in_range = (slot >= 0) & (slot < K);
  // the slot's stored score: its owner lane reads it, the warp takes it
  const int owner = in_range ? slot & 31 : 0;
  const int mine_at = (in_range & (lane == owner)) ? row(slot) : 0;
  const int at_slot = __shfl_sync(kFull, mine_at, owner);
  e_new = (valid & is_proven(p)) ? p : at_slot;
  int best = 0;
  bool all_proven = true;
  for (int k = lane; k < K; k += 32) {
    if (!act(k)) continue;
    const int v = k == slot ? e_new : row(k);
    best = max(best, v);
    all_proven = all_proven & is_proven(v);
  }
  best = __reduce_max_sync(kFull, best);
  all_proven = __all_sync(kFull, all_proven);
  const bool provable = is_win(best) | (all_proven & complete & is_proven(best));
  return (valid & provable) ? best : ns;
}

// score_scan for K > 32: one row per warp, levels bottom-up.
__global__ void __launch_bounds__(kWarps * 32) score_scan_wide_kernel(
    const int32_t* __restrict__ start, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ sl, const int32_t* __restrict__ es,
    const uint8_t* __restrict__ ea, const uint8_t* __restrict__ comp,
    const int32_t* __restrict__ ns, int32_t* __restrict__ e_out,
    int32_t* __restrict__ ns_out, int R, int D, int K) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= R) return;  // uniform per warp
  const int lane = threadIdx.x & 31;
  int child = start[row];
  for (int d = D - 1; d >= 0; --d) {
    const int64_t at = row * D + d;
    const bool vd = valid[at] != 0;
    const int32_t* es_row = es + at * K;
    const uint8_t* ea_row = ea + at * K;
    int e_new;
    const int ns_new = wide_level(
        invert_up(child), [&](int k) { return es_row[k]; }, [&](int k) { return ea_row[k] != 0; },
        sl[at], vd, comp[at] != 0, ns[at], K, lane, e_new);
    child = vd ? ns_new : child;
    if (lane == 0) {
      e_out[at] = e_new;
      ns_out[at] = ns_new;
    }
  }
}

// score_backup for K > 32: one board's path per warp, levels bottom-up,
// each level's row read from the tree and its new scores written back
// before the next (shallower) level, which names another node.
__global__ void __launch_bounds__(kWarps * 32) score_backup_wide_kernel(
    int32_t* edge_score, const int32_t* __restrict__ edge_action,
    const uint8_t* __restrict__ node_complete, int32_t* node_score,
    const int64_t* __restrict__ pn, const int64_t* __restrict__ ps,
    const int32_t* __restrict__ start, int B, int N, int D, int K) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // uniform per warp
  const int lane = threadIdx.x & 31;
  const int64_t tree = b * N;  // node 0 of this board
  int child = start[b];
  for (int d = D - 1; d >= 0; --d) {
    const int64_t node64 = pn[b * D + d];
    if (node64 == kNull) continue;  // the scan passes the child through
    const int64_t slot64 = ps[b * D + d];
    if (node64 < 0 || node64 >= N || slot64 < 0 || slot64 >= K) __trap();
    const int64_t node = tree + node64;
    const int slot = static_cast<int>(slot64);
    const int32_t* es_row = edge_score + node * K;
    const int32_t* ea_row = edge_action + node * K;
    int e_new;
    const int ns_new = wide_level(
        invert_up(child), [&](int k) { return es_row[k]; },
        [&](int k) { return ea_row[k] != kNull; }, slot, true, node_complete[node] != 0,
        node_score[node], K, lane, e_new);
    __syncwarp();  // every lane's reads of this row before the writes
    if (lane == 0) {
      edge_score[node * K + slot] = e_new;
      node_score[node] = ns_new;
    }
    child = ns_new;
  }
}

template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int* info) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel, kWarps * 32, 0);
  info[1] = attr.numRegs;
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = static_cast<int>(attr.localSizeBytes);
  return err;
}

}  // namespace

extern "C" int ag_score_scan(const void* start, const void* valid, const void* sl,
                             const void* es, const void* ea, const void* comp,
                             const void* ns, void* e_out, void* ns_out, int R, int D,
                             int K, void* stream) {
  if (R <= 0 || D <= 0 || K <= 0) return 0;
  auto kernel = K > 32     ? &score_scan_wide_kernel
                : D <= 16 ? &score_scan_kernel<16>
                          : &score_scan_kernel<32>;
  kernel<<<(R + kWarps - 1) / kWarps, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(start), static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(sl), static_cast<const int32_t*>(es),
      static_cast<const uint8_t*>(ea), static_cast<const uint8_t*>(comp),
      static_cast<const int32_t*>(ns), static_cast<int32_t*>(e_out),
      static_cast<int32_t*>(ns_out), R, D, K);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ag_score_backup(void* edge_score, const void* edge_action,
                               const void* node_complete, void* node_score, const void* pn,
                               const void* ps, const void* start, int B, int N, int D, int K,
                               void* stream) {
  if (B <= 0 || D <= 0 || K <= 0) return 0;
  auto kernel = K > 32     ? &score_backup_wide_kernel
                : D <= 16 ? &score_backup_kernel<16>
                          : &score_backup_kernel<32>;
  kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(edge_score), static_cast<const int32_t*>(edge_action),
      static_cast<const uint8_t*>(node_complete), static_cast<int32_t*>(node_score),
      static_cast<const int64_t*>(pn), static_cast<const int64_t*>(ps),
      static_cast<const int32_t*>(start), B, N, D, K);
  return static_cast<int>(cudaGetLastError());
}

// What an instantiation gets from the card: `backup` picks score_backup
// (else score_scan), `D` the depth it is launched for, `K` the edge slots
// (K > 32: the wide kernel).  info[0] blocks per SM, info[1] registers per
// thread, info[2] static shared memory (bytes), info[3] local memory
// (spills) per thread (bytes).
extern "C" int ag_score_scan_occupancy(int backup, int D, int K, int* info) {
  if (K > 32) {
    return static_cast<int>(backup ? occupancy(&score_backup_wide_kernel, info)
                                   : occupancy(&score_scan_wide_kernel, info));
  }
  if (backup) {
    return static_cast<int>(
        occupancy(D <= 16 ? &score_backup_kernel<16> : &score_backup_kernel<32>, info));
  }
  return static_cast<int>(occupancy(D <= 16 ? &score_scan_kernel<16> : &score_scan_kernel<32>, info));
}

extern "C" const char* ag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
