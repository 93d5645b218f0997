"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch twins.
Importing this package builds nothing: a kernel is compiled at its first
launch (see ``_build``)."""
