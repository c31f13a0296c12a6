"""theanet_tpu — a JAX/XLA image-classification training framework with the
full capability surface of the Theano reference ``rakeshvar/theanet``:
in-graph per-batch augmentation, dict-driven network specs, per-layer
momentum SGD with L1/L2/max-norm, multiple output heads, pickle
checkpoint/resume, and pluggable dataset modules, with the dataset resident
in device memory and one compiled program per epoch.
"""

from . import layers
from .model import (
    NeuralNet,
    get_layers_info,
    get_training_params_info,
    get_wts_info,
)

__version__ = "0.1.0"

__all__ = [
    "layers",
    "NeuralNet",
    "get_layers_info",
    "get_wts_info",
    "get_training_params_info",
]
