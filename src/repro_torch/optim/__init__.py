from repro_torch.optim.sgd import sgd_update  # noqa: F401
