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
// Two entry points share one scan core (`scan_levels`; `wide_levels` for
// K > 32):
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
// One warp per row.  K <= 32 (lanes >= K are inactive) takes the staged
// kernels above, kWarps rows a block.  K > 32 takes the wide kernels
// (`score_scan_wide_kernel`, `score_backup_wide_kernel`), the same four
// stages with the rows in shared memory:
//   1. a chunk of kWideD = 16 levels: lane d loads level d's scalars (for
//      score_backup, first the path's indices, as above), and the chunk's
//      rows go into the warp's slice of shared memory by cp.async, every
//      copy issued before one wait (score_scan: the chunk's es and ea rows,
//      one span each, in 16-byte copies but for the ends; score_backup:
//      each valid level's edge-score and edge-action rows, a word a copy);
//   2. lane l reads slots l, l + 32, ... of every level, no branch on
//      activity, so the levels' reads and reductions interleave; one
//      __reduce_max_sync a level and one __reduce_or_sync for all levels
//      give each level's max and "all proven" over its other active slots;
//      lane d reads its own traversed slot (`wide_levels`); then U, P
//      and their invert_up as in scan_levels (`finish_levels`);
//   3. the chain of scan_levels (`finish_levels`), on registers;
//   4. lane d writes level d's results, after every read.
// Why shared memory and not registers: a lane would hold kWideD *
// ceil(K / 32) scores, 128 registers at K = 225 and more at K = 400, and
// the rows are read once by stage 2 in any order; one wait on the staged
// chunk replaces the per-level round trips of the design before this one,
// which loaded each level's row after the level below.  What bounds it:
// as the staged kernels, one memory latency a chunk (two for
// score_backup) and the chain's integer latency, then stage 2's issue,
// which grows with kL * K / 32.  The chunk is 16 levels at every K (the
// engine's D = 40 takes three), and a block takes as many rows as fit in
// the 48 KB of dynamic shared memory a block has without opting in, 1 to
// kWarps: score_scan stages 80 bytes a slot (4 rows a block up to K = 153,
// 3 from 154, 2 from 205, 1 from 307), score_backup 128 (4 rows up to
// K = 96, 3 from 97, 2 from 129, 1 from 193); one row opts in above 48 KB
// (score_scan from K = 615, score_backup from K = 385), up to the card's
// 227 KB a block (K = 2,905 and 1,816; a larger K fails to launch).
// Scores are packed uint16 values carried zero-extended in int32, exactly
// as the port's tree stores them; masks are bytes (torch.bool).

#include <algorithm>
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

// Stage 2's end and stage 3 for the lowest kL levels of a chunk, from what
// stage 2 reduced: lane d holds level d's scalars in `mine`, its traversed
// slot's score and activity in at_slot and slot_active, and the max and
// "all proven" of the level's other active slots in best_others and
// others_proven.  p and the results as scan_levels.
template <int kL>
__device__ __forceinline__ int finish_levels(int p, const LaneLevel& mine, int at_slot,
                                             bool slot_active, int best_others,
                                             bool others_proven, int lane, int& e_mine,
                                             int& ns_mine) {
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
  return finish_levels<kL>(p, mine, at_slot, slot_active, best_others, others_proven, lane,
                           e_mine, ns_mine);
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

// The wide kernels (K > 32).  Levels a chunk: the rows of kWideD levels
// are staged in shared memory at once.
constexpr int kWideD = 16;
constexpr int kSmemDefault = 48 * 1024;  // dynamic shared memory a block gets without opting in

__host__ __device__ __forceinline__ int round16(int n) { return (n + 15) & ~15; }
// A warp's staging buffer: score_scan's chunk of es rows (one span, at the
// source's offset mod 16) and of ea bytes (the same); score_backup's two
// rows (edge scores, edge actions) for each level of the chunk.
__host__ __device__ __forceinline__ int wide_scan_warp_bytes(int K) {
  return round16(kWideD * 4 * K + 12) + round16(kWideD * K + 15);
}
__host__ __device__ __forceinline__ int wide_backup_warp_bytes(int K) { return 2 * kWideD * 4 * K; }

__device__ __forceinline__ void cp_async16(uint32_t dst, uintptr_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, uintptr_t src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies the n bytes at `src` (n and src multiples of kUnit) into shared
// memory at dst + src % 16, dst 16-byte aligned, and returns src % 16.  The
// warp's lanes take the 16-byte-aligned middle in 16-byte cp.async copies,
// and the ragged ends (up to 15 bytes each) one kUnit piece a lane: by
// cp.async for kUnit = 4, by a load and a store for bytes (cp.async copies
// 4, 8 or 16 bytes, aligned).  Nothing waits here: the caller issues every
// copy of a chunk, then cp_async_wait_all() and __syncwarp().
template <int kUnit>
__device__ __forceinline__ int stage(unsigned char* dst, const void* src, int64_t n, int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src), e = a + n;
  const uintptr_t base = a & ~uintptr_t{15};  // lands at dst
  const uintptr_t up = (a + 15) & ~uintptr_t{15}, down = e & ~uintptr_t{15};
  const uintptr_t mid = up < e ? up : e;  // the aligned middle: [mid, end)
  const uintptr_t end = down > mid ? down : mid;
  const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  for (uintptr_t g = mid + 16 * lane; g < end; g += 32 * 16) {
    cp_async16(to + static_cast<uint32_t>(g - base), g);
  }
  const int head = static_cast<int>(mid - a) / kUnit, tail = static_cast<int>(e - end) / kUnit;
  if (lane < head + tail) {
    const uintptr_t g = lane < head ? a + lane * kUnit : end + (lane - head) * kUnit;
    if constexpr (kUnit == 4) {
      cp_async4(to + static_cast<uint32_t>(g - base), g);
    } else {
      dst[g - base] = *reinterpret_cast<const uint8_t*>(g);
    }
  }
  return static_cast<int>(a & 15);
}

// Stages 2 and 3 of a wide chunk for its lowest kL levels; every level from
// kL up is invalid.  `row(d, k)` and `act(d, k)` read slot k of level d (d
// < kL, known at compile time) where stage 1 put it in shared memory; bit d
// of `staged` says level d's rows are there (the other levels' slots count
// as inactive).  Lane d holds level d's scalars in `mine`, and the score and
// the activity of its traversed slot in at_slot and slot_active (0 and
// false where the slot is out of range).  The rest as scan_levels: p in and
// out, lane d < kL gets level d's new scores in e_mine and ns_mine.
//
// Stage 2 has four quantities of each level to reduce over K, none of them
// depending on p: the traversed slot's score and activity (lane d reads
// them itself), and the max and "all proven" of the other active slots.
// Lane l reads slots l, l + 32, ... of every level, with no branch on
// activity, so that the levels' reads interleave; one __reduce_max_sync per
// level and one __reduce_or_sync for all of them finish the row.  Stage 3
// is scan_levels' (`finish_levels`).
template <int kL, typename Row, typename Act>
__device__ __forceinline__ int wide_levels(int p, Row row, Act act, unsigned staged,
                                           const LaneLevel& mine, int at_slot, bool slot_active,
                                           int K, int lane, int& e_mine, int& ns_mine) {
  const int slot_mine = mine.slot >= 0 && mine.slot < K ? mine.slot : -1;  // -1: out of range
  int slot[kL], best[kL];
#pragma unroll
  for (int d = 0; d < kL; ++d) {
    slot[d] = __shfl_sync(kFull, slot_mine, d);
    best[d] = 0;
  }
  unsigned unproven = 0;  // bit d: an active slot of level d but its traversed one is unproven
#pragma unroll 1
  for (int k = lane; k < K; k += 32) {
#pragma unroll
    for (int d = 0; d < kL; ++d) {
      const int v = row(d, k);
      const bool other = (((staged >> d) & 1u) != 0) & act(d, k) & (k != slot[d]);
      best[d] = max(best[d], other ? v : 0);
      unproven |= (other & !is_proven(v)) ? 1u << d : 0u;
    }
  }
  const unsigned any_unproven = __reduce_or_sync(kFull, unproven);
  int best_others = 0;
#pragma unroll
  for (int d = 0; d < kL; ++d) {
    const int b = __reduce_max_sync(kFull, best[d]);
    if (lane == d) best_others = b;
  }
  const bool others_proven = ((any_unproven >> lane) & 1u) == 0;
  return finish_levels<kL>(p, mine, at_slot, slot_active, best_others, others_proven, lane,
                           e_mine, ns_mine);
}

// score_scan for K > 32: one row per warp, chunks of kWideD levels,
// deepest first, each staged whole in the warp's shared memory.
__global__ void __launch_bounds__(kWarps * 32) score_scan_wide_kernel(
    const int32_t* __restrict__ start, const uint8_t* __restrict__ valid,
    const int32_t* __restrict__ sl, const int32_t* __restrict__ es,
    const uint8_t* __restrict__ ea, const uint8_t* __restrict__ comp,
    const int32_t* __restrict__ ns, int32_t* __restrict__ e_out,
    int32_t* __restrict__ ns_out, int R, int D, int K) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  const int warp = threadIdx.x >> 5;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (row >= R) return;  // uniform per warp; a warp's collectives meet only its own lanes
  const int lane = threadIdx.x & 31;
  unsigned char* es_buf = wide_smem + warp * wide_scan_warp_bytes(K);
  unsigned char* ea_buf = es_buf + round16(kWideD * 4 * K + 12);
  int p = invert_up(start[row]);
  for (int lo = (D - 1) / kWideD * kWideD; lo >= 0; lo -= kWideD) {
    const int n = min(kWideD, D - lo);
    const int64_t base = row * D + lo;  // level lo of this row
    // stage 1: lane d's scalars, then the chunk's rows (contiguous: one
    // span of es, one of ea), every copy issued before the one wait
    const bool mine_in = lane < n;
    const LaneLevel mine{ld_byte_or_false(valid + base + lane, mine_in),
                         ld_byte_or_false(comp + base + lane, mine_in),
                         ld_or_zero(sl + base + lane, mine_in),
                         ld_or_zero(ns + base + lane, mine_in)};
    const int es_shift = stage<4>(es_buf, es + base * K, int64_t{4} * n * K, lane);
    const int ea_shift = stage<1>(ea_buf, ea + base * K, int64_t{n} * K, lane);
    cp_async_wait_all();
    __syncwarp();
    const int32_t* es_s = reinterpret_cast<const int32_t*>(es_buf + es_shift);
    const uint8_t* ea_s = ea_buf + ea_shift;
    const bool own = mine_in & (mine.slot >= 0) & (mine.slot < K);
    const int at_slot = own ? es_s[lane * K + mine.slot] : 0;
    const bool slot_active = own && ea_s[lane * K + mine.slot] != 0;
    // the rest over the levels up to the deepest valid one (uniform)
    const unsigned valid_row = __ballot_sync(kFull, mine.valid);
    const unsigned staged = (1u << n) - 1;
    auto row_at = [&](int d, int k) { return es_s[d * K + k]; };
    auto act_at = [&](int d, int k) { return ea_s[d * K + k] != 0; };
    int e_mine = at_slot, ns_mine = mine.ns;  // a chunk with no valid level passes p through
#define AG_WIDE_LEVELS(kL) \
  wide_levels<kL>(p, row_at, act_at, staged, mine, at_slot, slot_active, K, lane, e_mine, ns_mine)
    if (valid_row >= (1u << 8)) {
      p = AG_WIDE_LEVELS(kWideD);
    } else if (valid_row >= (1u << 4)) {
      p = AG_WIDE_LEVELS(8);
    } else if (valid_row != 0) {
      p = AG_WIDE_LEVELS(4);
    }
#undef AG_WIDE_LEVELS
    // stage 4, after every read of the staged rows, which the next chunk's
    // copies overwrite
    __syncwarp();
    if (mine_in) {
      e_out[base + lane] = e_mine;
      ns_out[base + lane] = ns_mine;
    }
  }
}

// score_backup's stages 1b to 4 for the lowest kL levels of a wide chunk,
// all of the path's valid levels there: stage the rows the path names,
// scan, write the new scores into the tree.  `buf` is the warp's staging
// buffer: level d's edge scores at words d K, its edge actions kWideD K
// words further.  A row is K words anywhere in the tree, so the lanes copy
// it a word each, slots lane, lane + 32, ...: more copies than 16-byte
// ones, but none of the per-row alignment arithmetic that those need,
// which cost more than it saved on the card.
template <int kL>
__device__ __forceinline__ int wide_backup_levels(int p, int32_t* edge_score,
                                                  const int32_t* __restrict__ edge_action,
                                                  const uint8_t* __restrict__ node_complete,
                                                  int32_t* node_score, unsigned char* buf,
                                                  int64_t tree, bool valid, unsigned valid_row,
                                                  int node, int slot, int K, int lane) {
  const LaneLevel mine{valid, ld_byte_or_false(node_complete + tree + node, valid), slot,
                       ld_or_zero(node_score + tree + node, valid)};
  int32_t* es_s = reinterpret_cast<int32_t*>(buf);
  int32_t* ea_s = es_s + kWideD * K;
  const uint32_t es_to = static_cast<uint32_t>(__cvta_generic_to_shared(es_s));
  const uint32_t ea_to = static_cast<uint32_t>(__cvta_generic_to_shared(ea_s));
#pragma unroll
  for (int d = 0; d < kL; ++d) {
    const int nd = __shfl_sync(kFull, node, d);
    if ((valid_row >> d) & 1u) {
      const int32_t* es_row = edge_score + (tree + nd) * K;
      const int32_t* ea_row = edge_action + (tree + nd) * K;
      for (int k = lane; k < K; k += 32) {
        cp_async4(es_to + 4 * (d * K + k), reinterpret_cast<uintptr_t>(es_row + k));
        cp_async4(ea_to + 4 * (d * K + k), reinterpret_cast<uintptr_t>(ea_row + k));
      }
    }
  }
  cp_async_wait_all();
  __syncwarp();
  // lane d's own level
  const int at_slot = valid ? es_s[lane * K + slot] : 0;
  const bool slot_active = valid && ea_s[lane * K + slot] != kNull;
  auto row_at = [&](int d, int k) { return es_s[d * K + k]; };
  auto act_at = [&](int d, int k) { return ea_s[d * K + k] != kNull; };
  int e_mine = 0, ns_mine = 0;
  p = wide_levels<kL>(p, row_at, act_at, valid_row, mine, at_slot, slot_active, K, lane, e_mine,
                      ns_mine);
  // stage 4: after every read of this chunk (stage 2 read the staged rows);
  // a deeper chunk's writes precede a shallower chunk's reads, which touch
  // other nodes since a path visits a node at most once
  __syncwarp();
  if (valid) {
    edge_score[(tree + node) * K + slot] = e_mine;
    node_score[tree + node] = ns_mine;
  }
  return p;
}

// score_backup for K > 32: one board's path per warp, in chunks of kWideD
// levels, deepest first, as score_backup_kernel.
__global__ void __launch_bounds__(kWarps * 32) score_backup_wide_kernel(
    int32_t* edge_score, const int32_t* __restrict__ edge_action,
    const uint8_t* __restrict__ node_complete, int32_t* node_score,
    const int64_t* __restrict__ pn, const int64_t* __restrict__ ps,
    const int32_t* __restrict__ start, int B, int N, int D, int K) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  const int warp = threadIdx.x >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (b >= B) return;  // uniform per warp; a warp's collectives meet only its own lanes
  const int lane = threadIdx.x & 31;
  const int64_t tree = b * N;  // node 0 of this board
  unsigned char* buf = wide_smem + warp * wide_backup_warp_bytes(K);
  int p = invert_up(start[b]);
  for (int lo = (D - 1) / kWideD * kWideD; lo >= 0; lo -= kWideD) {
    const int n = min(kWideD, D - lo);
    // stage 1a: the path's indices, lane d for level lo + d
    const int64_t node64 = ld_or_null(pn + b * D + lo + lane, lane < n);
    const int64_t slot64 = ld_or_null(ps + b * D + lo + lane, lane < n);
    const bool valid = node64 != kNull;
    if (valid && (node64 < 0 || node64 >= N || slot64 < 0 || slot64 >= K)) __trap();
    const int node = valid ? static_cast<int>(node64) : 0;
    const int slot = valid ? static_cast<int>(slot64) : 0;
    const unsigned valid_row = __ballot_sync(kFull, valid);
    // the rest over the levels up to the deepest valid one (uniform); a
    // chunk with none passes p through and writes nothing
#define AG_WIDE_BACKUP_LEVELS(kL)                                                              \
  wide_backup_levels<kL>(p, edge_score, edge_action, node_complete, node_score, buf, tree,   \
                         valid, valid_row, node, slot, K, lane)
    if (valid_row >= (1u << 8)) {
      p = AG_WIDE_BACKUP_LEVELS(kWideD);
    } else if (valid_row >= (1u << 4)) {
      p = AG_WIDE_BACKUP_LEVELS(8);
    } else if (valid_row != 0) {
      p = AG_WIDE_BACKUP_LEVELS(4);
    }
#undef AG_WIDE_BACKUP_LEVELS
  }
}

// Rows (warps) a block of a wide kernel takes, each with `warp_bytes` of
// dynamic shared memory: as many as fit in the 48 KB a block gets without
// opting in, 1 to kWarps.  A single warp above that opts in (K >= 615 for
// score_scan, K >= 385 for score_backup), up to the card's 227 KB.
int wide_warps(int warp_bytes) { return std::max(1, std::min(kWarps, kSmemDefault / warp_bytes)); }

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  if (bytes <= kSmemDefault) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int* info, int warps = kWarps, int dyn_smem = 0) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = allow_smem(kernel, dyn_smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&info[0], kernel, warps * 32, dyn_smem);
  info[1] = attr.numRegs;
  info[2] = static_cast<int>(attr.sharedSizeBytes);
  info[3] = static_cast<int>(attr.localSizeBytes);
  info[4] = dyn_smem;
  info[5] = warps;
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
  const int warps = K > 32 ? wide_warps(wide_scan_warp_bytes(K)) : kWarps;
  const int smem = K > 32 ? warps * wide_scan_warp_bytes(K) : 0;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(R + warps - 1) / warps, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
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
  const int warps = K > 32 ? wide_warps(wide_backup_warp_bytes(K)) : kWarps;
  const int smem = K > 32 ? warps * wide_backup_warp_bytes(K) : 0;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(B + warps - 1) / warps, warps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(edge_score), static_cast<const int32_t*>(edge_action),
      static_cast<const uint8_t*>(node_complete), static_cast<int32_t*>(node_score),
      static_cast<const int64_t*>(pn), static_cast<const int64_t*>(ps),
      static_cast<const int32_t*>(start), B, N, D, K);
  return static_cast<int>(cudaGetLastError());
}

// What an instantiation gets from the card: `backup` picks score_backup
// (else score_scan), `D` the depth it is launched for, `K` the edge slots
// (K > 32: the wide kernel, with its launch's rows a block and dynamic
// shared memory at this K).  info[0] blocks per SM, info[1] registers per
// thread, info[2] static shared memory (bytes), info[3] local memory
// (spills) per thread (bytes), info[4] dynamic shared memory a block
// (bytes), info[5] rows (warps) a block.
extern "C" int ag_score_scan_occupancy(int backup, int D, int K, int* info) {
  if (K > 32) {
    const int bytes = backup ? wide_backup_warp_bytes(K) : wide_scan_warp_bytes(K);
    const int warps = wide_warps(bytes);
    return static_cast<int>(
        backup ? occupancy(&score_backup_wide_kernel, info, warps, warps * bytes)
               : occupancy(&score_scan_wide_kernel, info, warps, warps * bytes));
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
