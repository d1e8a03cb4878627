# The single-device partitioner of the PyTorch port: multilevel V-cycle with
# Jet refinement and probabilistic rebalancing (mirrors repro.core).
from repro_torch.core.config import UNSET, PartitionConfig, resolve_config  # noqa: F401
from repro_torch.core.graph import (  # noqa: F401
    PAD, Graph, from_arrays, from_coo, pad_graph, resolve_device, to_padded_fast)
from repro_torch.core.jet import jet_round  # noqa: F401
from repro_torch.core.multilevel import PartitionResult, partition  # noqa: F401
from repro_torch.core.partition import (  # noqa: F401
    best_moves,
    block_weights,
    conn_dense,
    edge_cut,
    imbalance,
    l_max,
    total_overload,
)
from repro_torch.core.rebalance import greedy_epoch, probabilistic_pass, rebalance  # noqa: F401
from repro_torch.core.refine import jet_refine, lp_refine_balanced, temperature_schedule  # noqa: F401
