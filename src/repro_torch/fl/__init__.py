from repro_torch.fl.backend import cnn_backend  # noqa: F401
