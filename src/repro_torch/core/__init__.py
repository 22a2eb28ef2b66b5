# The paper's primary contribution: feature-based semantics-aware (VAoI)
# scheduling for energy-harvesting federated learning, in PyTorch.
from repro_torch.core.channel import SCENARIOS as CHANNEL_SCENARIOS  # noqa: F401
from repro_torch.core.channel import ChannelProcess, make_channel  # noqa: F401
from repro_torch.core.draws import EpochDraws, InitDraws, ReplayDraws, TorchDraws  # noqa: F401
from repro_torch.core.harvest import SCENARIOS, HarvestProcess, make_process  # noqa: F401
from repro_torch.core.simulator import (  # noqa: F401
    Backend,
    EHFLConfig,
    init_carry,
    make_epoch_fn,
    run_batch,
    run_simulation,
)
from repro_torch.core.vaoi import client_select, feature_distance, select_topk, vaoi_update  # noqa: F401
from repro_torch.data.stream import SCENARIOS as STREAM_SCENARIOS  # noqa: F401
from repro_torch.data.stream import DataStream, make_stream  # noqa: F401
