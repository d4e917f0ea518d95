"""The paper's own model and engine configurations (Tables I and II).

DTM-L: clause matrix 32×27, weight matrix 8×4, 24-bit LFSRs.  DTM-S:
32×16 and 2×4, 12-bit LFSRs.  The tiles keep the paper's buffer
capacities with lane-aligned tile dims, as in the JAX package.

MNIST geometry: 784 Boolean features, 10 classes.  KWS-6: 1600 Boolean
features, 6 classes.
"""
from repro_torch.core.types import COALESCED, TMConfig, TileConfig, VANILLA

DTM_L_TILE = TileConfig(x=256, y=128, m=128, n=8,
                        max_features=1024, max_clauses=2048, max_classes=16)
DTM_S_TILE = TileConfig(x=128, y=64, m=64, n=8,
                        max_features=512, max_clauses=512, max_classes=16)

TM_MNIST_COTM = TMConfig(
    tm_type=COALESCED, features=784, clauses=2000, classes=10,
    T=500, s=10.0, ta_bits=8, weight_bits=12, lfsr_bits=24)

TM_MNIST_VANILLA = TMConfig(
    tm_type=VANILLA, features=784, clauses=200, classes=10,
    T=500, s=10.0, ta_bits=8, lfsr_bits=24)

TM_KWS6_COTM = TMConfig(
    tm_type=COALESCED, features=1600, clauses=2000, classes=6,
    T=1000, s=5.0, ta_bits=8, weight_bits=12, lfsr_bits=24)

TM_KWS6_VANILLA = TMConfig(
    tm_type=VANILLA, features=1600, clauses=700, classes=6,
    T=500, s=5.0, ta_bits=8, lfsr_bits=24)
