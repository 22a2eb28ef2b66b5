from repro_torch.data.stream import (  # noqa: F401
    CLASS_CONDITIONED,
    DataStream,
    apply_view,
    make_stream,
)
from repro_torch.data.stream import SCENARIOS as STREAM_SCENARIOS  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    dirichlet_label_partition,
    make_federated_dataset,
    make_token_dataset,
)
