"""PyTorch/CUDA port of latteclip_tpu for NVIDIA Hopper.

The package mirrors ``latteclip_tpu`` module for module; ``latteclip_tpu``
stays the numerical reference. Attention runs through CUDA C++ kernels
written for ``sm_90a`` (``kernels/csrc``); everything around them is plain
PyTorch. Entry points take ``device=`` and default to ``"cuda"``.
"""
