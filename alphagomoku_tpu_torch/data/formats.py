"""Reference dataset binary formats: GameDataBuffer files v100/v200/v201.

Byte-exact reader/writer for the reference's replay buffer files so parity
tooling can exchange data with the C++ implementation (reference:
src/dataset/GameDataBuffer.cpp:97-128 file framing,
src/dataset/GameDataStorage.cpp:27-100 game records,
src/dataset/SearchDataStorage.cpp per-move records,
include/alphagomoku/utils/low_precision.hpp the LowFP quantizers,
include/alphagomoku/utils/file_util.hpp:26-41 serializeVector).

File framing: JSON header + '\n' + raw binary blob, zlib-compressed as one
stream (FileSaver::save(json, binary, -1, compress=true)).  The JSON holds
{"format", "config", "offsets": [per-game byte offsets]}.

Quantizers (all little-endian):
  fp16_format   = LowFP<0,5,11,-16>  (record scales)
  visit_format  = LowFP<0,3,5,-8>    (8-bit visit counts)
  policy_format = LowFP<0,4,4,-16>   (8-bit priors)
  value_format  = LowFP<0,4,4,-16>   (8-bit win/draw rates)
  score_format  = LowFP<1,3,2,-8>    (6-bit eval inside score_to_int8)

A copy of the reference package's `data/formats.py` (numpy, struct and
zlib): files are byte-identical to the reference package's.  Of its
optional ctypes codec (`native/libagdata.so`, built from `native/agdata.cpp`
by `make -C native`) the port keeps the reader, `parse_game_native`, with a
loader of its own; the writer and `load_buffer` stay Python.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import struct
import zlib
from pathlib import Path

import numpy as np


class LowFP:
    """Reference LowFP<S,E,M,B> custom float (low_precision.hpp:20-157)."""

    def __init__(self, s: int, e: int, m: int, b: int):
        self.S, self.E, self.M, self.B = s, e, m, b
        self.max_exponent = (1 << e) - 1 + b
        self.min_exponent = b
        self.max_mantissa = (1 << m) - 1

    def to_lowp(self, x: float) -> int:
        # float32 arithmetic throughout, bit-matching the C++ (to_lowp,
        # low_precision.hpp:111-120)
        f32 = np.float32
        x = f32(x)
        bits = struct.unpack("<I", struct.pack("<f", x))[0]
        bitsize = self.S + self.E + self.M
        sign = ((bits & 0x80000000) >> (32 - bitsize)) if self.S else 0
        exponent = ((bits & 0x7F800000) >> 23) - 127
        exponent = max(self.min_exponent, min(self.max_exponent, exponent))
        is_subnormal = 1 if exponent == self.min_exponent else 0
        mag = x if sign == 0 else f32(-x)
        base = f32(
            f32(mag * f32(math.ldexp(1.0, -(exponent + is_subnormal))))
            + f32(is_subnormal - 1)
        )
        mantissa = min(self.max_mantissa, int(f32(base * (1 << self.M)) + f32(0.5)))
        return sign | ((exponent - self.B) << self.M) | mantissa

    def to_fp32(self, x: int) -> float:
        sign_mask = (1 << (self.E + self.M)) if self.S else 0
        exponent = ((x >> self.M) & ((1 << self.E) - 1)) + self.B
        base = (x & self.max_mantissa) / (1 << self.M)
        is_subnormal = 1 if exponent == self.min_exponent else 0
        val = (1 - is_subnormal + base) * math.ldexp(1.0, exponent + is_subnormal)
        return -val if (self.S and (x & sign_mask)) else val

    def max(self) -> float:
        bitsize = self.S + self.E + self.M
        top = (1 << bitsize) - 1 if self.S == 0 else (1 << (bitsize - 1)) - 1
        return self.to_fp32(top)


FP16 = LowFP(0, 5, 11, -16)
VISIT = LowFP(0, 3, 5, -8)
POLICY = LowFP(0, 4, 4, -16)
VALUE = LowFP(0, 4, 4, -16)
SCORE6 = LowFP(1, 3, 2, -8)

# packed Score helpers (Score.hpp:47-68: 3b ProvenValue << 13 | 4000+eval)
PV_LOSS, PV_DRAW, PV_UNKNOWN, PV_WIN = 0, 1, 2, 3


def score_u16(pv: int, eval_or_dist: int) -> int:
    if pv == PV_WIN:
        return (pv << 13) | (4000 - eval_or_dist)
    if pv in (PV_LOSS, PV_DRAW):
        return (pv << 13) | (4000 + eval_or_dist)
    return (pv << 13) | (4000 + eval_or_dist)


def score_to_int8(s: int) -> int:
    """(SearchDataStorage.cpp:24-31)"""
    pv = (s >> 13) & 7
    ev = (s & 0x1FFF) - 4000
    if pv != PV_UNKNOWN:
        dist = -ev if pv == PV_WIN else ev
        return (pv << 6) | max(0, min(63, dist))
    return (pv << 6) | SCORE6.to_lowp(ev / 1000.0)


def int8_to_score(x: int) -> int:
    """(SearchDataStorage.cpp:32-49)"""
    pv = (x >> 6) & 3
    low = x & 63
    if pv == PV_WIN:
        return score_u16(PV_WIN, low)
    if pv in (PV_LOSS, PV_DRAW):
        return score_u16(pv, low)
    return score_u16(PV_UNKNOWN, int(1000.0 * SCORE6.to_fp32(low) + 0.5))


@dataclasses.dataclass
class SearchRecord:
    """One move's search data over the HW cells (SearchDataPack shape)."""

    visit_count: np.ndarray  # [HW] int32
    policy_prior: np.ndarray  # [HW] f32
    win_rate: np.ndarray  # [HW] f32 action values
    draw_rate: np.ndarray  # [HW] f32
    action_scores: np.ndarray  # [HW] uint16 packed Score
    minimax_score: int  # packed Score
    move_number: int
    flags: int = 0


@dataclasses.dataclass
class GameData:
    """One game (GameDataStorage): per-move records + move list + outcome."""

    records: list
    moves: list  # uint16 toShort() == (col << 8) | row; sign implicit
    outcome: int  # GameOutcome int
    rows: int
    cols: int


def _serialize_record_v201(rec: SearchRecord, out: bytearray) -> None:
    """(SearchDataStorage_v201::loadFrom + serialize, :326-419).
    All scale math in float32, matching the C++ bit-for-bit."""
    f32 = np.float32
    hw = len(rec.visit_count)
    proven = ((rec.action_scores >> 13) & 7) != PV_UNKNOWN
    policy_scale = f32(rec.policy_prior.astype(np.float32).max()) if hw else f32(0)
    value_scale = (
        f32(max(rec.win_rate.astype(np.float32).max(), rec.draw_rate.astype(np.float32).max()))
        if hw
        else f32(0)
    )
    visit_scale = f32(max(1.0, float(rec.visit_count.max())))
    policy_scale = f32(1.0) if policy_scale == 0.0 else f32(policy_scale / f32(POLICY.max()))
    value_scale = f32(1.0) if value_scale == 0.0 else f32(value_scale / f32(POLICY.max()))
    visit_scale = f32(visit_scale / f32(VISIT.max()))

    entries = []
    last = 0
    for i in range(hw):
        if rec.visit_count[i] > 0 or proven[i] or (i - last) >= 255:
            entries.append(
                (
                    i - last,
                    VISIT.to_lowp(f32(f32(rec.visit_count[i]) / visit_scale)),
                    POLICY.to_lowp(f32(f32(rec.policy_prior[i]) / policy_scale)),
                    score_to_int8(int(rec.action_scores[i])),
                    VALUE.to_lowp(f32(f32(rec.win_rate[i]) / value_scale)),
                    VALUE.to_lowp(f32(f32(rec.draw_rate[i]) / value_scale)),
                )
            )
            last = i
    out += struct.pack(
        "<HHHHHH",
        FP16.to_lowp(value_scale),
        FP16.to_lowp(policy_scale),
        FP16.to_lowp(visit_scale),
        rec.minimax_score & 0xFFFF,
        rec.move_number & 0xFFFF,
        rec.flags & 0xFFFF,
    )
    out += struct.pack("<I", len(entries))
    for e in entries:
        out += struct.pack("<6B", *e)


def _parse_record_v201(buf: memoryview, off: int, hw: int):
    vs, ps, vis, score, move_number, flags = struct.unpack_from("<HHHHHH", buf, off)
    off += 12
    value_scale = FP16.to_fp32(vs)
    policy_scale = FP16.to_fp32(ps)
    visit_scale = FP16.to_fp32(vis)
    (count,) = struct.unpack_from("<I", buf, off)
    off += 4
    rec = SearchRecord(
        visit_count=np.zeros(hw, np.int32),
        policy_prior=np.zeros(hw, np.float32),
        win_rate=np.zeros(hw, np.float32),
        draw_rate=np.zeros(hw, np.float32),
        action_scores=np.full(hw, score_u16(PV_UNKNOWN, 0), np.uint16),
        minimax_score=score,
        move_number=move_number,
        flags=flags,
    )
    idx = 0
    for _ in range(count):
        d, v, p, s8, wr, dr = struct.unpack_from("<6B", buf, off)
        off += 6
        idx += d
        rec.visit_count[idx] = int(VISIT.to_fp32(v) * visit_scale + 0.5)
        rec.policy_prior[idx] = POLICY.to_fp32(p) * policy_scale
        rec.win_rate[idx] = VALUE.to_fp32(wr) * value_scale
        rec.draw_rate[idx] = VALUE.to_fp32(dr) * value_scale
        rec.action_scores[idx] = int8_to_score(s8)
    return rec, off


def _serialize_record_v200(rec: SearchRecord, out: bytearray) -> None:
    """v200 record = v201 minus the trailing flags u16
    (SearchDataStorage_v2::loadFrom + serialize, SearchDataStorage.cpp:166-280).
    The scale/entry math is shared with the v201 writer."""
    tmp = bytearray()
    _serialize_record_v201(rec, tmp)
    # v201 header: vs, ps, vis, score, move#, flags (6 u16) — drop flags
    out += tmp[:10]
    out += tmp[12:]


def _parse_record_v200(buf: memoryview, off: int, hw: int):
    vs, ps, vis, score, move_number = struct.unpack_from("<HHHHH", buf, off)
    off += 10
    value_scale = FP16.to_fp32(vs)
    policy_scale = FP16.to_fp32(ps)
    visit_scale = FP16.to_fp32(vis)
    (count,) = struct.unpack_from("<I", buf, off)
    off += 4
    rec = SearchRecord(
        visit_count=np.zeros(hw, np.int32),
        policy_prior=np.zeros(hw, np.float32),
        win_rate=np.zeros(hw, np.float32),
        draw_rate=np.zeros(hw, np.float32),
        action_scores=np.full(hw, score_u16(PV_UNKNOWN, 0), np.uint16),
        minimax_score=score,
        move_number=move_number,
        flags=0,
    )
    idx = 0
    for _ in range(count):
        d, v, p, s8, wr, dr = struct.unpack_from("<6B", buf, off)
        off += 6
        idx += d
        rec.visit_count[idx] = int(VISIT.to_fp32(v) * visit_scale + 0.5)
        rec.policy_prior[idx] = POLICY.to_fp32(p) * policy_scale
        rec.win_rate[idx] = VALUE.to_fp32(wr) * value_scale
        rec.draw_rate[idx] = VALUE.to_fp32(dr) * value_scale
        rec.action_scores[idx] = int8_to_score(s8)
    return rec, off


def _serialize_record_v1(rec: SearchRecord, out: bytearray) -> None:
    """v100: 12-byte entries, 16-bit CompressedFloats
    (SearchDataStorage::serialize, :79-140)."""
    hw = len(rec.visit_count)
    proven = ((rec.action_scores >> 13) & 7) != PV_UNKNOWN
    entries = []
    for i in range(hw):
        if rec.visit_count[i] > 0 or proven[i]:
            entries.append(i)
    out += struct.pack("<HH", rec.minimax_score & 0xFFFF, rec.move_number & 0xFFFF)
    out += struct.pack("<I", len(entries))
    cols = int(round(math.sqrt(hw)))
    for i in entries:
        r, c = i // cols, i % cols
        out += struct.pack(
            "<BBHHHHH",
            r & 0xFF,
            c & 0xFF,
            min(0xFFFF, int(rec.visit_count[i])),
            int(65535.0 * min(1.0, rec.policy_prior[i])),
            int(rec.action_scores[i]),
            int(65535.0 * min(1.0, rec.win_rate[i])),
            int(65535.0 * min(1.0, rec.draw_rate[i])),
        )


def _parse_record_v1(buf: memoryview, off: int, hw: int):
    score, move_number = struct.unpack_from("<HH", buf, off)
    off += 4
    (count,) = struct.unpack_from("<I", buf, off)
    off += 4
    cols = int(round(math.sqrt(hw)))
    rec = SearchRecord(
        visit_count=np.zeros(hw, np.int32),
        policy_prior=np.zeros(hw, np.float32),
        win_rate=np.zeros(hw, np.float32),
        draw_rate=np.zeros(hw, np.float32),
        action_scores=np.full(hw, score_u16(PV_UNKNOWN, 0), np.uint16),
        minimax_score=score,
        move_number=move_number,
    )
    for _ in range(count):
        r, c, v, p, s, wr, dr = struct.unpack_from("<BBHHHHH", buf, off)
        off += 12
        i = r * cols + c
        rec.visit_count[i] = v
        rec.policy_prior[i] = p / 65535.0
        rec.action_scores[i] = s
        rec.win_rate[i] = wr / 65535.0
        rec.draw_rate[i] = dr / 65535.0
    return rec, off


def _serialize_game(game: GameData, fmt: int, out: bytearray) -> None:
    out += struct.pack("<I", len(game.records))
    for rec in game.records:
        if fmt == 201:
            _serialize_record_v201(rec, out)
        elif fmt == 200:
            _serialize_record_v200(rec, out)
        elif fmt == 100:
            _serialize_record_v1(rec, out)
        else:
            raise ValueError(f"unsupported write format {fmt}")
    if fmt == 100:
        # vector<Move>: alignas(4) {Sign(int32) sign; int8 row; int8 col}
        # -> 8 bytes with 2 padding bytes (Move.hpp:92-96)
        out += struct.pack("<I", len(game.moves))
        for k, m in enumerate(game.moves):
            sign = 1 + (k % 2)
            out += struct.pack("<iBBxx", sign, m & 0xFF, (m >> 8) & 0xFF)
    else:
        # vector<uint16_t> of Location::toShort()
        out += struct.pack("<I", len(game.moves))
        for m in game.moves:
            out += struct.pack("<H", m)
    out += struct.pack("<iii", game.outcome, game.rows, game.cols)


def parse_game(buf: memoryview, off: int, fmt: int, hw: int) -> tuple[GameData, int]:
    (n_states,) = struct.unpack_from("<I", buf, off)
    off += 4
    records = []
    for _ in range(n_states):
        if fmt == 201:
            rec, off = _parse_record_v201(buf, off, hw)
        elif fmt == 200:
            rec, off = _parse_record_v200(buf, off, hw)
        elif fmt == 100:
            rec, off = _parse_record_v1(buf, off, hw)
        else:
            raise ValueError(f"unsupported read format {fmt}")
        records.append(rec)
    (count,) = struct.unpack_from("<I", buf, off)
    off += 4
    moves = []
    if fmt == 100:
        for _ in range(count):
            sign, row, col = struct.unpack_from("<iBB", buf, off)
            off += 8
            moves.append(((col & 0xFF) << 8) | (row & 0xFF))
    else:
        for _ in range(count):
            (m,) = struct.unpack_from("<H", buf, off)
            off += 2
            moves.append(m)
    outcome, rows, cols = struct.unpack_from("<iii", buf, off)
    off += 12
    return GameData(records, moves, outcome, rows, cols), off


# the native codec, native/libagdata.so at the repository root, and the
# ABI it must report: a stale library called through these signatures is
# undefined behaviour
NATIVE_LIB = Path(__file__).resolve().parents[2] / "native" / "libagdata.so"
NATIVE_ABI = 2
_NATIVE: dict = {}


def native_lib(path=None):
    """The native codec loaded with ctypes (its argument types set), or None
    where the library is absent or reports another ABI.  Loaded once per
    path."""
    import ctypes as c

    path = str(path or NATIVE_LIB)
    if path in _NATIVE:
        return _NATIVE[path]
    lib = None
    if os.path.exists(path):
        lib = c.CDLL(path)
        try:
            lib.ag_abi_version.restype = c.c_int
            lib.ag_abi_version.argtypes = []
            if lib.ag_abi_version() != NATIVE_ABI:
                lib = None
        except AttributeError:
            lib = None
    if lib is not None:
        pi32, pf32, pu16 = c.POINTER(c.c_int32), c.POINTER(c.c_float), c.POINTER(c.c_uint16)
        lib.ag_parse_game.restype = c.c_int64
        lib.ag_parse_game.argtypes = [
            c.c_int, c.c_char_p, c.c_int64, c.c_int64, c.c_int, pi32,
            c.POINTER(pi32), c.POINTER(pf32), c.POINTER(pf32), c.POINTER(pf32),
            c.POINTER(pu16), c.POINTER(pu16), c.POINTER(pu16), c.POINTER(pu16),
            c.POINTER(pu16), pi32, pi32, pi32, pi32,
        ]
        lib.ag_free.restype = None
        lib.ag_free.argtypes = [c.c_void_p]
    _NATIVE[path] = lib
    return lib


def parse_game_native(buf, off: int, fmt: int, hw: int, path=None):
    """`parse_game` through the native codec (`native_lib(path)`): (GameData,
    new_off), or None where the library is unavailable."""
    lib = native_lib(path)
    if lib is None:
        return None
    import ctypes as c

    raw = bytes(buf)
    n_rec, n_mv, outc, rows_o, cols_o = (c.c_int32() for _ in range(5))
    pi32, pf32, pu16 = c.POINTER(c.c_int32), c.POINTER(c.c_float), c.POINTER(c.c_uint16)
    visit, policy, win, draw = pi32(), pf32(), pf32(), pf32()
    scores, minimax, move_no, flags, moves = pu16(), pu16(), pu16(), pu16(), pu16()
    new_off = lib.ag_parse_game(
        fmt, raw, len(raw), off, hw, c.byref(n_rec), c.byref(visit), c.byref(policy),
        c.byref(win), c.byref(draw), c.byref(scores), c.byref(minimax), c.byref(move_no),
        c.byref(flags), c.byref(moves), c.byref(n_mv), c.byref(outc), c.byref(rows_o),
        c.byref(cols_o),
    )
    if new_off < 0:
        raise ValueError(f"native parse_game failed: {new_off}")
    n = n_rec.value

    def arr(p, count, dtype):
        return np.ctypeslib.as_array(p, shape=(count,)).astype(dtype, copy=True)

    per_cell = [arr(p, n * hw, dt).reshape(n, hw) for p, dt in (
        (visit, np.int32), (policy, np.float32), (win, np.float32), (draw, np.float32),
        (scores, np.uint16))]
    minimax_a, move_no_a, flags_a = (arr(p, n, np.uint16) for p in (minimax, move_no, flags))
    moves_a = arr(moves, max(1, n_mv.value), np.uint16)[: n_mv.value]
    for p in (visit, policy, win, draw, scores, minimax, move_no, flags, moves):
        lib.ag_free(p)
    records = [
        SearchRecord(
            visit_count=per_cell[0][i], policy_prior=per_cell[1][i], win_rate=per_cell[2][i],
            draw_rate=per_cell[3][i], action_scores=per_cell[4][i],
            minimax_score=int(minimax_a[i]), move_number=int(move_no_a[i]),
            flags=int(flags_a[i]),
        )
        for i in range(n)
    ]
    game = GameData(records, [int(m) for m in moves_a], int(outc.value), int(rows_o.value),
                    int(cols_o.value))
    return game, int(new_off)


def save_buffer(
    path: str,
    games: list,
    rows: int,
    cols: int,
    rules: str = "FREESTYLE",
    fmt: int = 201,
    compress: bool = True,
) -> None:
    """Write a reference-format buffer file (GameDataBuffer::save,
    GameDataBuffer.cpp:97-112)."""
    blob = bytearray()
    offsets = []
    for g in games:
        offsets.append(len(blob))
        _serialize_game(g, fmt, blob)
    header = {
        "format": fmt,
        "config": {
            "rows": rows,
            "cols": cols,
            "rules": rules,
            "draw_after": rows * cols,
        },
        "offsets": offsets,
    }
    payload = json.dumps(header).encode() + b"\n" + bytes(blob)
    if compress:
        payload = zlib.compress(payload)
    with open(path, "wb") as fh:
        fh.write(payload)


def load_buffer(path: str) -> tuple[dict, list]:
    """Read a reference-format buffer file -> (config dict, [GameData])
    (GameDataBuffer::load, GameDataBuffer.cpp:113-128)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    try:
        raw = zlib.decompress(raw)
    except zlib.error:
        pass  # uncompressed file
    # FileLoader::find_split_point: the JSON header ends at brace balance
    depth = 0
    split = 0
    for i, ch in enumerate(raw):
        if ch in b"{[":
            depth += 1
        elif ch in b"}]":
            depth -= 1
            if depth == 0:
                split = i + 1
                break
    header = json.loads(raw[:split].decode())
    blob = memoryview(raw[split + 1 :]) if raw[split : split + 1] == b"\n" else memoryview(raw[split:])
    fmt = header.get("format", 100)
    cfg = header["config"]
    hw = int(cfg["rows"]) * int(cfg["cols"])
    games = [parse_game(blob, int(off), fmt, hw)[0] for off in header["offsets"]]
    return header, games
