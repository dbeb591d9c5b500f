"""PyTorch/CUDA port of the KHI range-filtered ANN system (``repro`` is the
JAX reference). Entry points run on CUDA unless given ``device="cpu"``;
the hand-written kernels live in ``repro_torch.kernels``."""
