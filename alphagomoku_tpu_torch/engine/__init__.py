"""The playing engine: protocols, the engine facade, the time manager and
the launcher (`python3 -m alphagomoku_tpu_torch.engine.manager`); the
reference package's `engine` exports.  `ProgramManager` is imported on
first use, so that running the launcher module does not import it twice."""

from .protocol import (
    InputListener,
    Message,
    MessageQueue,
    MessageType,
    OutputSender,
    Protocol,
)
from .gomocup import GomocupProtocol, ExtendedGomocupProtocol
from .engine import Engine, SearchSummary
from .time_manager import TimeManager, MovesLeftEstimator

__all__ = [
    "InputListener",
    "Message",
    "MessageQueue",
    "MessageType",
    "OutputSender",
    "Protocol",
    "GomocupProtocol",
    "ExtendedGomocupProtocol",
    "Engine",
    "SearchSummary",
    "TimeManager",
    "MovesLeftEstimator",
    "ProgramManager",
]


def __getattr__(name):
    if name == "ProgramManager":
        from .manager import ProgramManager

        return ProgramManager
    raise AttributeError(name)
