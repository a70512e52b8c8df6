"""Mez on PyTorch and CUDA: the port of the ``repro`` package to one NVIDIA
H100.

This package imports ``torch`` and never ``jax`` or anything of ``repro``.
Its entry points run on the CUDA device unless the caller passes
``device="cpu"``; without a CUDA device they raise ``RuntimeError``.
"""
