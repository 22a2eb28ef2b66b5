"""The paper's own client model (§V): CNN with six convolutional layers,
three max-pooling layers, and three fully-connected layers, for CIFAR-10
(32x32x3, 10 classes).  The port's own copy of ``repro.configs.cifar_cnn``."""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class CNNConfig:
    name: str = "cifar-cnn"
    family: str = "cnn"
    image_size: int = 32
    in_channels: int = 3
    num_classes: int = 10
    # six conv layers in three (conv, conv, maxpool) stages
    conv_channels: Tuple[int, ...] = (32, 32, 64, 64, 128, 128)
    fc_dims: Tuple[int, ...] = (256, 128)  # two hidden FC + final classifier = 3 FC
    source: str = "paper §V"


CONFIG = CNNConfig()


def reduced_cnn() -> CNNConfig:
    return CNNConfig(
        name="cifar-cnn-reduced",
        conv_channels=(8, 8, 16, 16, 32, 32),
        fc_dims=(64, 32),
    )
