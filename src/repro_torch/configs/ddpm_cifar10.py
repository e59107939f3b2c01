"""The paper's DDPM CIFAR-10 network as the reference builds it — CNN
path: ``zoo.ddpm_unet()``, a DDPM-shaped UNet chain (32², base 128, two
down and two up levels with concat skips, GN, one attention barrier;
about 11.7 M parameters), not Ho et al.'s full 35.7 M-parameter UNet."""
from repro_torch.models import zoo

CONFIG = zoo.ddpm_unet()
