from .match import MatchResult, Opponent, play_match, play_multi_match, random_openings, elo_from_winrate
from .gsprt import GSPRT
from .spsa import SPSA
from .tuner import EngineTuner, TunableParam, config_from_theta

__all__ = [
    "MatchResult",
    "Opponent",
    "play_match",
    "play_multi_match",
    "random_openings",
    "elo_from_winrate",
    "GSPRT",
    "SPSA",
    "EngineTuner",
    "TunableParam",
    "config_from_theta",
]
