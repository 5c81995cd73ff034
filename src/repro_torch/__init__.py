"""PyTorch + CUDA port of the ZettaLith FP4 CASCADE serving stack.

Module layout and names follow the JAX package module for module, so each
counterpart is easy to find. This package imports ``torch`` and never JAX.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a card and without that argument they raise.
"""
