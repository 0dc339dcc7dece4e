"""Hot-path kernels: CUDA C++ for Hopper in ``csrc/``, a plain PyTorch
version of each in ``ref``, and device dispatch in ``ops``."""
