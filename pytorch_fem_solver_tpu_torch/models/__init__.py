"""VPINN models: the MLP trial function and its training harness."""

from .model import Model
from .network import FeedForwardNeuralNetwork, identity_bc

__all__ = ["FeedForwardNeuralNetwork", "Model", "identity_bc"]
