"""Hand-written CUDA kernels of the port (``csrc/``), their plain PyTorch
versions (``ref.py``) and the wrappers the engine calls (``ops.py``).
Nothing is compiled at import time."""
