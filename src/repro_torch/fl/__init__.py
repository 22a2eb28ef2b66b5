from repro_torch.fl.backend import cnn_backend, lm_backend  # noqa: F401
