"""The paper's own ResNet-34 (He et al. 2016) — CNN path."""
from repro_torch.models import zoo

CONFIG = zoo.resnet34()
