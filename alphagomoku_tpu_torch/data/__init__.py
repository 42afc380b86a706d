from .replay import ReplayBuffer, FIELDS

__all__ = ["ReplayBuffer", "FIELDS"]
