"""The benchmark of the PyTorch/CUDA port (``latteclip_torch``); see README.md."""
