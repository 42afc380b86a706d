from . import nnue
from .networks import (
    AGNetwork,
    ModelConfig,
    NetOutput,
    NetEval,
    create_network,
    list_architectures,
    postprocess,
    value_expectation,
)

__all__ = [
    "nnue",
    "AGNetwork",
    "ModelConfig",
    "NetOutput",
    "NetEval",
    "create_network",
    "list_architectures",
    "postprocess",
    "value_expectation",
]
