"""Post-training quantization of the speculative serving path
(``repro.quant``).

  qweight  : int8 / int4 weight quantization (per-channel / grouped absmax,
             optional AWQ-lite activation-aware pre-scale) into ``QWeight``s,
             which the model's matmul dispatch sends to the quantized matmul
             kernel (``kernels.ops.dequant_matmul``).
  calib    : whole-model ``quantize_params`` and the AWQ calibration forward
             (calibration batches from the distillation datagen pipeline).
  kvcache  : int8 KV cache with per-slot-per-head scales.
  roofline : modeled bytes of one decode step.
"""
from .qweight import (QWeight, dequantize, params_nbytes,  # noqa: F401
                      quantize_weight)
from .calib import (QUANT_WEIGHT_NAMES, cast_unquantized,  # noqa: F401
                    collect_act_stats, quantize_params)
from .kvcache import (dequantize_kv_entry, kv_quantized,  # noqa: F401
                      quantize_kv_cache, quantize_kv_entry)
from .roofline import DecodeBytes, decode_step_bytes  # noqa: F401
