"""Hand-written CUDA kernels for Hopper (sources in ../csrc), their plain
PyTorch versions (ref.py) and the engine-facing ops (ops.py)."""
