from repro_torch.configs.cifar_cnn import CONFIG, CNNConfig, reduced_cnn  # noqa: F401
