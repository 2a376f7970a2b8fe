"""PyTorch port of the ``repro`` JAX stack, for NVIDIA Hopper.

Module paths and public names follow ``repro``; parameters are nested dicts
of tensors with the same names and axis order.  Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.  The package imports
neither JAX nor ``repro``.
"""
