"""Post-training int8 quantization (counterpart of ``vip_cup_2022_tpu/quant``)."""
from .ptq import (  # noqa: F401
    PTQConfig,
    QuantizedSite,
    calibrate,
    load_scales,
    quantized,
    save_scales,
)
