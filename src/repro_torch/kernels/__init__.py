"""Hand-written CUDA kernels for Hopper (sources in ../csrc), their plain
PyTorch versions (ref.py) and the engine-facing ops (ops.py)."""
# the engine first: ref.py imports core.booleanize, whose package imports
# the engine, which imports ops.py and through it every wrapper module
import repro_torch.core  # noqa: F401
