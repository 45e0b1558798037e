"""Post-training quantization of the port: calibrate -> int8/bf16 -> serve.

    calibrate   observers (minmax / percentile-histogram) over a
                representative iterator -> `CalibrationStats` (+ crc32)
    ptq         `quantize_model` -> `QuantizedModel`: int8 per-channel
                weights with a bf16 fallback for range-hostile tensors,
                served through the stock serving stack
                (`ModelRegistry.register_quantized`); `parity_check` is the
                accuracy gate

The kernels are in ``ops.quant_kernels`` and ``ops/kernels/matmul.py``
(``q_matmul``, ``int8_matmul``).  A SameDiff graph (an imported ONNX model)
quantizes as the ``samediff`` kind.  The fleet integration
(``ModelFleet.quantize``) and the quantized Keras kind are not ported
yet.
"""
from deeplearning4j_tpu_torch.ops.quant_kernels import (  # noqa: F401
    QTensor, dequantize, quantize_tensor)
from deeplearning4j_tpu_torch.quant.calibrate import (  # noqa: F401
    CalibrationStats, MinMaxObserver, PercentileObserver, calibrate)
from deeplearning4j_tpu_torch.quant.ptq import (  # noqa: F401
    QuantConfig, QuantizedModel, parity_check, quantize_model)
