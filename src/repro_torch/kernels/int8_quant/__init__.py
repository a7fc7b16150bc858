from repro_torch.kernels.int8_quant.ops import (  # noqa: F401
    GROUP, int8_dequantize, int8_quantize)
