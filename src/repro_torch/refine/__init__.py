"""Refinement engine of the PyTorch port: one Jet core over a comm backend
and a gain backend (mirrors repro.refine, single device)."""

from repro_torch.refine.comm import EdgeView, SingleComm, edge_view_from_graph  # noqa: F401
from repro_torch.refine.drivers import (  # noqa: F401
    level_tolerances,
    refine_single,
    reset_counters,
)
from repro_torch.refine.gain import (  # noqa: F401
    KernelGain,
    SegmentGain,
    make_gain,
    masked_best,
    resolve_gain,
)
from repro_torch.refine.schedule import SCHEDULES, ToleranceSchedule, resolve_schedule  # noqa: F401
from repro_torch.refine.variants import (  # noqa: F401
    Variant,
    register,
    registered_variants,
    resolve_variant,
)
