from .compressed import (  # noqa: F401
    compressed_psum,
    dequantize_int8,
    init_residual,
    quantize_int8,
)
from .step import make_train_step  # noqa: F401
