"""The paper's own MobileNetV2-1.0 (Sandler et al. 2018) — CNN path;
``CONFIG_14`` is the paper's MobileNetV2-1.4."""
from repro_torch.models import zoo

CONFIG = zoo.mobilenetv2(width_mult=1.0)
CONFIG_14 = zoo.mobilenetv2(width_mult=1.4)
