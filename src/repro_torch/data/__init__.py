"""Synthetic datasets with the paper's geometry and the data pipeline."""
from .pipeline import HostShardIterator, Prefetcher, Source
from .datasets import (BoolTaskSpec, FMNIST_LIKE, KMNIST_LIKE, KWS6_LIKE,
                       MNIST_LIKE, make_bool_dataset, make_lm_tokens, motifs)

__all__ = ["Source", "HostShardIterator", "Prefetcher", "BoolTaskSpec",
           "MNIST_LIKE", "FMNIST_LIKE", "KMNIST_LIKE", "KWS6_LIKE",
           "make_bool_dataset", "make_lm_tokens", "motifs"]
