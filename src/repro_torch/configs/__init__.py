from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    get_config,
    list_configs,
    reduced,
    register,
)
from repro_torch.configs.cifar_cnn import CONFIG, CNNConfig, reduced_cnn  # noqa: F401
