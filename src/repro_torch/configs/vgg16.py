"""VGG-16 (CIFAR variant) — the paper's large model [Simonyan & Zisserman
2014]. ``stages`` is the classic VGG-16 conv plan: (channels, n_convs) per
max-pool stage.
"""
from repro_torch.configs.base import CNNConfig, register

CONFIG = register(CNNConfig(
    name="vgg16",
    family="vgg",
    stages=((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)),
    source="VGG [arXiv:1409.1556]; S2FL paper Sec. 5.1",
))
