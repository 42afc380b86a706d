"""Small shared utilities (reference: src/utils/misc.cpp): copies of
`get_simulations_for_move` and `zfill` from `alphagomoku_tpu/utils/misc.py`."""

from __future__ import annotations


def get_simulations_for_move(
    draw_rate: float, max_simulations: int, min_simulations: int
) -> int:
    """Reduce the simulation budget when games mostly draw
    (reference: src/utils/misc.cpp:171-179; used by GameGenerator for
    dynamic simulation reduction, GameGenerator.cpp:97-99)."""
    draw_threshold = 0.75
    reduction = min(
        1.0, max(0.0, (draw_rate - draw_threshold) / (1.0 - draw_threshold))
    )
    return int(max_simulations - reduction * (max_simulations - min_simulations))


def zfill(value: int, length: int) -> str:
    """|value| in decimal, padded with zeros to `length` digits."""
    return str(abs(value)).zfill(length)
