from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    get_config,
    input_specs,
    list_configs,
    reduced,
    register,
    YaRN,
)
from repro_torch.configs.cifar_cnn import CONFIG, CNNConfig, reduced_cnn  # noqa: F401
