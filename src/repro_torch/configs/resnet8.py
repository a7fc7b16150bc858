"""ResNet-8 for CIFAR — the paper's smallest model [He et al. 2016].

Stem conv + 3 residual stages (1 basic block each) + linear head = 8
weighted layers. ``stages`` = (channels, n_blocks, stride) per stage.
"""
from repro_torch.configs.base import CNNConfig, register

CONFIG = register(CNNConfig(
    name="resnet8",
    family="resnet",
    stages=((16, 1, 1), (32, 1, 2), (64, 1, 2)),
    source="ResNet [He et al., CVPR 2016]; S2FL paper Sec. 5.1",
))
