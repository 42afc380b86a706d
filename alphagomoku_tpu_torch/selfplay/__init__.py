from .selfplay import (
    SelfplayConfig,
    GameRecord,
    SelfplayResult,
    PlayCarry,
    MoveDraws,
    draw_move,
    init_carry,
    make_move_step,
    play_games,
    play_games_resumable,
    make_targets,
)
from .openings import propose_random_openings, generate_balanced_openings, opening_env

__all__ = [
    "SelfplayConfig",
    "GameRecord",
    "SelfplayResult",
    "PlayCarry",
    "MoveDraws",
    "draw_move",
    "init_carry",
    "make_move_step",
    "play_games",
    "play_games_resumable",
    "make_targets",
    "propose_random_openings",
    "generate_balanced_openings",
    "opening_env",
]
