"""The port's reference dataset formats (`data/formats.py`: LowFP, the
score packing, v100/v200/v201 records, save_buffer/load_buffer) held
against the JAX package's writer and parser: files byte-identical for
every format, compressed and not, and the reference's own serializer
(oracle/parity_oracle, where it is built) byte-identical on its datapacks;
`parse_game_native` through a codec built from native/agdata.cpp equal to
the Python parser."""

import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from alphagomoku_tpu.data import formats as JF

from alphagomoku_tpu_torch.data import formats as F

torch.set_num_threads(1)


def test_lowfp_equals_jax():
    xs = np.concatenate([np.linspace(0.0, 70000.0, 257), np.geomspace(1e-7, 1e5, 257),
                         -np.geomspace(1e-4, 10.0, 33)]).astype(np.float32)
    for ours, ref in ((F.FP16, JF.FP16), (F.VISIT, JF.VISIT), (F.POLICY, JF.POLICY),
                      (F.VALUE, JF.VALUE), (F.SCORE6, JF.SCORE6)):
        signed = ref.S == 1
        for x in xs:
            if x < 0 and not signed:
                continue
            assert ours.to_lowp(float(x)) == ref.to_lowp(float(x))
        for code in range(1 << (ref.S + ref.E + ref.M)):
            assert ours.to_fp32(code) == ref.to_fp32(code)
        assert ours.max() == ref.max()


def test_lowfp_roundtrip_monotone():
    for fmt in (F.FP16, F.VISIT, F.POLICY, F.VALUE):
        xs = np.linspace(0.0, fmt.max() * 0.999, 200)
        enc = [fmt.to_lowp(float(x)) for x in xs]
        dec = [fmt.to_fp32(e) for e in enc]
        assert all(e2 >= e1 for e1, e2 in zip(enc, enc[1:]))
        rel = [abs(d - x) / max(1e-6, x) for x, d in zip(xs[1:], dec[1:])]
        assert max(rel) < 0.2


def test_score_packing_equals_jax():
    for pv in (F.PV_LOSS, F.PV_DRAW, F.PV_UNKNOWN, F.PV_WIN):
        for d in list(range(0, 70, 3)) + [-1000, -500, -3, 120, 900, 1000]:
            s = F.score_u16(pv, d)
            assert s == JF.score_u16(pv, d)
            assert F.score_to_int8(s) == JF.score_to_int8(s)
    for x in range(256):
        assert F.int8_to_score(x) == JF.int8_to_score(x)
    for pv, d in [(F.PV_WIN, 5), (F.PV_LOSS, 12), (F.PV_DRAW, 0)]:
        s = F.score_u16(pv, d)
        assert F.int8_to_score(F.score_to_int8(s)) == s


def _records(mod, rng, hw, n):
    """`n` search records of package `mod` from one seeded draw."""
    out = []
    for m in range(n):
        visit = np.zeros(hw, np.int32)
        hot = rng.choice(hw, size=int(rng.integers(1, 12)), replace=False)
        visit[hot] = rng.integers(1, 900, size=len(hot))
        policy = np.zeros(hw, np.float32)
        policy[hot] = rng.random(len(hot)).astype(np.float32)
        win = np.zeros(hw, np.float32)
        draw = np.zeros(hw, np.float32)
        win[hot] = rng.random(len(hot)).astype(np.float32)
        draw[hot] = (rng.random(len(hot)) * 0.3).astype(np.float32)
        scores = np.full(hw, mod.score_u16(mod.PV_UNKNOWN, 0), np.uint16)
        if rng.random() < 0.5:
            scores[hot[0]] = mod.score_u16(mod.PV_WIN, int(rng.integers(1, 30)))
        if rng.random() < 0.3:
            scores[hot[-1]] = mod.score_u16(mod.PV_LOSS, int(rng.integers(1, 30)))
        out.append(mod.SearchRecord(
            visit_count=visit, policy_prior=policy, win_rate=win, draw_rate=draw,
            action_scores=scores,
            minimax_score=int(mod.score_u16(mod.PV_UNKNOWN, int(rng.integers(-900, 900)))),
            move_number=m, flags=int(rng.integers(0, 4)),
        ))
    return out


def _games(mod, seed, n_games, rows, cols):
    rng = np.random.default_rng(seed)
    games = []
    for _ in range(n_games):
        n_rec = int(rng.integers(0, 6))
        records = _records(mod, rng, rows * cols, n_rec)
        moves = [int(((c & 0xFF) << 8) | (r & 0xFF)) for r, c in
                 zip(rng.integers(0, rows, n_rec), rng.integers(0, cols, n_rec))]
        games.append(mod.GameData(records, moves, int(rng.integers(0, 4)), rows, cols))
    return games


def _assert_games_equal(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert (a.moves, a.outcome, a.rows, a.cols) == (b.moves, b.outcome, b.rows, b.cols)
        assert len(a.records) == len(b.records)
        for r0, r1 in zip(a.records, b.records):
            for field in ("visit_count", "policy_prior", "win_rate", "draw_rate",
                          "action_scores"):
                x, y = getattr(r0, field), getattr(r1, field)
                assert x.dtype == y.dtype and np.array_equal(x, y), field
            assert (r0.minimax_score, r0.move_number, r0.flags) == (
                r1.minimax_score, r1.move_number, r1.flags)


@pytest.mark.parametrize("fmt", [100, 200, 201])
@pytest.mark.parametrize("compress", [True, False], ids=["zlib", "raw"])
def test_buffer_files_byte_identical(tmp_path, fmt, compress):
    """The same games written by both packages give the same bytes, and
    each package's loader reads either file to the same values."""
    for rows, cols, rules in ((15, 15, "FREESTYLE"), (9, 9, "RENJU")):
        ours_path = str(tmp_path / f"ours_{fmt}_{rows}.bin")
        ref_path = str(tmp_path / f"ref_{fmt}_{rows}.bin")
        F.save_buffer(ours_path, _games(F, fmt + rows, 5, rows, cols), rows, cols, rules=rules,
                      fmt=fmt, compress=compress)
        JF.save_buffer(ref_path, _games(JF, fmt + rows, 5, rows, cols), rows, cols, rules=rules,
                       fmt=fmt, compress=compress, use_native=False)
        with open(ours_path, "rb") as a, open(ref_path, "rb") as b:
            assert a.read() == b.read()
        header, ours = F.load_buffer(ref_path)
        ref_header, ref = JF.load_buffer(ours_path)
        assert header == ref_header and header["format"] == fmt
        _assert_games_equal(ours, ref)


@pytest.mark.parametrize("fmt", [100, 200, 201])
def test_game_bytes_and_parse_equal_jax(fmt):
    for g_ours, g_ref in zip(_games(F, 40 + fmt, 4, 15, 15), _games(JF, 40 + fmt, 4, 15, 15)):
        a, b = bytearray(), bytearray()
        F._serialize_game(g_ours, fmt, a)
        JF._serialize_game(g_ref, fmt, b)
        assert bytes(a) == bytes(b)
        ours, off = F.parse_game(memoryview(bytes(a)), 0, fmt, 225)
        ref, ref_off = JF.parse_game(memoryview(bytes(b)), 0, fmt, 225)
        assert off == ref_off == len(a)
        _assert_games_equal([ours], [ref])


def test_buffer_roundtrip_values(tmp_path):
    games = _games(F, 0, 3, 9, 9)
    path = str(tmp_path / "buffer.bin")
    F.save_buffer(path, games, rows=9, cols=9, fmt=201)
    _, loaded = F.load_buffer(path)
    for g0, g1 in zip(games, loaded):
        assert g1.moves == g0.moves and g1.outcome == g0.outcome
        for r0, r1 in zip(g0.records, g1.records):
            nz = r0.visit_count > 0
            tol = np.maximum(2, r0.visit_count[nz] * 0.15)
            assert (np.abs(r1.visit_count[nz] - r0.visit_count[nz]) <= tol).all()
            proven = ((r0.action_scores >> 13) & 7) != F.PV_UNKNOWN
            assert (r1.action_scores[proven] == r0.action_scores[proven]).all()


def test_v201_byte_parity_vs_reference_oracle():
    """Byte-exact record serialization vs the reference dataset code
    compiled in oracle/parity_oracle (datapack command)."""
    oracle = os.path.join(os.path.dirname(__file__), "..", "oracle", "parity_oracle")
    if not os.path.exists(oracle):
        pytest.skip("parity oracle not built")
    proc = subprocess.Popen([oracle], stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)

    def lcg(seed):
        s = seed & 0xFFFFFFFFFFFFFFFF

        def next_():
            nonlocal s
            s = (s * 6364136223846793005 + 1442695040888963407) & 0xFFFFFFFFFFFFFFFF
            return (s >> 33) & 0xFFFFFFFF

        return next_

    rows = cols = 15
    hw = rows * cols
    f32 = np.float32
    try:
        for seed, version in [(1, 201), (7, 201), (1234, 201), (999983, 201),
                              (1, 200), (7, 200), (1234, 200), (999983, 200)]:
            proc.stdin.write(f"datapack {seed} {rows} {cols} {version}\n")
            proc.stdin.flush()
            ref_hex = proc.stdout.readline().strip()
            nxt = lcg(seed)
            rec = F.SearchRecord(
                visit_count=np.zeros(hw, np.int32), policy_prior=np.zeros(hw, np.float32),
                win_rate=np.zeros(hw, np.float32), draw_rate=np.zeros(hw, np.float32),
                action_scores=np.full(hw, F.score_u16(F.PV_UNKNOWN, 0), np.uint16),
                minimax_score=0, move_number=0,
            )
            for i in range(hw):
                if (nxt() & 7) == 0:
                    rec.visit_count[i] = 1 + nxt() % 500
                    rec.policy_prior[i] = f32(nxt() % 10000) / f32(10000.0)
                    wr = f32(nxt() % 1000) / f32(1000.0)
                    dr = f32(f32(1.0) - wr) * f32(nxt() % 1000) / f32(1000.0)
                    rec.win_rate[i] = wr
                    rec.draw_rate[i] = dr
                    k = nxt() % 10
                    if k == 0:
                        rec.action_scores[i] = F.score_u16(F.PV_WIN, 1 + nxt() % 30)
                    elif k == 1:
                        rec.action_scores[i] = F.score_u16(F.PV_LOSS, 1 + nxt() % 30)
                    else:
                        rec.action_scores[i] = F.score_u16(F.PV_UNKNOWN, int(nxt() % 2001) - 1000)
            rec.minimax_score = F.score_u16(F.PV_UNKNOWN, int(nxt() % 2001) - 1000)
            out = bytearray()
            if version == 200:
                F._serialize_record_v200(rec, out)
            else:
                F._serialize_record_v201(rec, out)
            assert out.hex() == ref_hex, f"seed {seed} v{version}: byte divergence"
    finally:
        proc.stdin.write("quit\n")
        proc.stdin.flush()
        proc.wait(timeout=10)


@pytest.fixture(scope="module")
def native_codec(tmp_path_factory):
    """native/agdata.cpp built with g++ (the flags of native/Makefile) into a
    temporary directory."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build native/agdata.cpp")
    so = tmp_path_factory.mktemp("native") / "libagdata.so"
    src = Path(__file__).resolve().parents[1] / "native" / "agdata.cpp"
    subprocess.run(["g++", "-O2", "-fPIC", "-std=c++17", "-shared", "-o", str(so), str(src)],
                   check=True)
    return so


@pytest.mark.parametrize("fmt", [100, 200, 201])
def test_parse_game_native_equals_python(native_codec, fmt):
    """`parse_game_native` through the codec built from native/agdata.cpp
    reads every game of a buffer to the values and offsets of the port's
    Python `parse_game` (so of the JAX package's, by
    test_game_bytes_and_parse_equal_jax)."""
    blob = bytearray()
    for game in _games(F, 70 + fmt, 4, 15, 15):
        F._serialize_game(game, fmt, blob)
    off = native_off = 0
    while off < len(blob):
        ref, off = F.parse_game(memoryview(bytes(blob)), off, fmt, 225)
        ours, native_off = F.parse_game_native(blob, native_off, fmt, 225, path=native_codec)
        assert native_off == off
        _assert_games_equal([ours], [ref])
    assert F.native_lib(native_codec) is F.native_lib(native_codec)


def test_parse_game_native_without_the_library(tmp_path):
    assert F.native_lib(tmp_path / "libagdata.so") is None
    assert F.parse_game_native(b"", 0, 201, 225, path=tmp_path / "libagdata.so") is None
