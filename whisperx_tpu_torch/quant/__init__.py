from whisperx_tpu_torch.quant.core import (
    QuantConfig,
    QuantizedLinear,
    dequantize,
    make_quantized_linear,
    quant_linear_apply,
    quantize_model,
    quantize_tree,
    quantize_weight,
)

__all__ = [
    "QuantConfig",
    "QuantizedLinear",
    "dequantize",
    "make_quantized_linear",
    "quant_linear_apply",
    "quantize_model",
    "quantize_tree",
    "quantize_weight",
]
