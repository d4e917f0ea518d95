"""Synthetic Boolean datasets with the paper's geometry."""
from .datasets import (BoolTaskSpec, KWS6_LIKE, MNIST_LIKE, make_bool_dataset,
                       motifs)

__all__ = ["BoolTaskSpec", "KWS6_LIKE", "MNIST_LIKE", "make_bool_dataset",
           "motifs"]
