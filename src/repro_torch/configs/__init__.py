"""The paper's TM model and engine configurations."""
from .tm_paper import (TM_MNIST_COTM, TM_MNIST_VANILLA, TM_KWS6_COTM,
                       TM_KWS6_VANILLA, DTM_L_TILE, DTM_S_TILE)

__all__ = ["TM_MNIST_COTM", "TM_MNIST_VANILLA", "TM_KWS6_COTM",
           "TM_KWS6_VANILLA", "DTM_L_TILE", "DTM_S_TILE"]
