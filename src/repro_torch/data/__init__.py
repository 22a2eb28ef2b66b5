from repro_torch.data.synthetic import (  # noqa: F401
    dirichlet_label_partition,
    make_federated_dataset,
)
