"""PyTorch + CUDA port of the BaM reproduction (``repro``).

The package mirrors ``repro``'s layout (``core/``, ``kernels/``, ``graph/``,
``utils.py``) so each counterpart is found by path.  It imports ``torch``,
numpy and the standard library only; the hot-path kernels are CUDA C++ for
Hopper (``kernels/csrc/``), built at first use, with a plain PyTorch version
beside each one that runs whenever the tensors lie on the CPU.

Entry points take ``device=`` and default to ``"cuda"``; without a CUDA
device they raise unless the caller passes ``device="cpu"``.
"""
