"""The LM substrate of the port: the model zoo's configuration schema,
layers, Mamba2 block and model assembly, counterparts of
``repro.models``. Plain PyTorch: no hand-written kernel, as the
reference is plain ``jnp``."""
