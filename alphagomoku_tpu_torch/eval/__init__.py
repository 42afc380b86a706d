from .match import MatchResult, Opponent, play_match, play_multi_match, random_openings, elo_from_winrate

__all__ = [
    "MatchResult",
    "Opponent",
    "play_match",
    "play_multi_match",
    "random_openings",
    "elo_from_winrate",
]
