from repro_torch.optim.sgd import adamw_init, adamw_update, sgd_update  # noqa: F401
