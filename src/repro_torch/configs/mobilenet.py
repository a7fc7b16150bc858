"""MobileNet-v1 (CIFAR variant) — depthwise-separable convs
[arXiv:1704.04861]. ``stages`` = (channels, stride) per separable block.
"""
from repro_torch.configs.base import CNNConfig, register

CONFIG = register(CNNConfig(
    name="mobilenet",
    family="mobilenet",
    stages=((64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
            (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
            (1024, 1)),
    source="MobileNet [arXiv:1704.04861]; S2FL paper Sec. 5.1",
))
