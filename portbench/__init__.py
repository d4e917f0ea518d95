"""The benchmark of repro_torch on NVIDIA cards (see run.py)."""
