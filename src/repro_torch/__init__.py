"""PyTorch and CUDA port of the DTM engine (serving slice).

The JAX package ``repro`` is the reference; this package imports neither
it nor JAX.  Entry points run on the card unless the caller passes
``device="cpu"``, where each kernel's plain version runs instead.
"""
