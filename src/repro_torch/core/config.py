"""The partitioning configuration object (port of ``repro/core/config.py``).

One frozen :class:`PartitionConfig` holds every static knob; the loose
keyword arguments of :func:`repro_torch.core.partition` are a thin facade
over it (explicitly passed kwargs override the config's fields).
Validation happens once, at construction.
"""

from __future__ import annotations

import dataclasses

from repro_torch.refine.gain import GAIN_BACKENDS
from repro_torch.refine.schedule import ToleranceSchedule, resolve_schedule
from repro_torch.refine.variants import Variant, resolve_variant


@dataclasses.dataclass(frozen=True)
class PartitionConfig:
    """Frozen bundle of every static partitioning knob.  ``seed`` is not a
    field: it is per-request identity, not configuration.

    ``gain`` defaults to ``"auto"`` (the scoreboard kernel where it fits);
    the reference's default ``"jnp"`` corresponds to ``"segment"``, and the
    backends give bit-identical partitions on integer-weight graphs.
    ``ckpt`` is kept as a field for the checkpoint slice of the port;
    :func:`~repro_torch.core.partition` rejects it until then.
    """

    k: int = 4
    eps: float = 0.03
    refiner: str = "d4xjet"
    schedule: str | ToleranceSchedule = "constant"
    eps_coarse: float | None = None
    gain: str = "auto"
    patience: int = 12
    max_inner: int = 64
    coarsen_until: int | None = None
    ckpt: object | None = None

    def __post_init__(self):
        resolve_variant(self.refiner)
        resolve_schedule(self.schedule, self.eps_coarse)
        if self.gain not in GAIN_BACKENDS:
            raise ValueError(
                f"unknown gain backend {self.gain!r}: known backends are "
                f"{list(GAIN_BACKENDS)}")
        if self.k < 1:
            raise ValueError(f"k must be >= 1, got {self.k}")
        if self.eps < 0:
            raise ValueError(f"eps must be >= 0, got {self.eps}")
        if self.patience < 1:
            raise ValueError(f"patience must be >= 1, got {self.patience}")
        if self.max_inner < 1:
            raise ValueError(f"max_inner must be >= 1, got {self.max_inner}")

    def variant(self) -> Variant:
        """The registered refinement variant (aliases resolved)."""
        return resolve_variant(self.refiner)

    def tolerance_schedule(self) -> ToleranceSchedule:
        """The resolved per-level tolerance schedule."""
        return resolve_schedule(self.schedule, self.eps_coarse)


_FIELDS = tuple(f.name for f in dataclasses.fields(PartitionConfig))


class _Unset:
    """Sentinel type for "kwarg not passed" facade defaults — distinct from
    ``None`` so an explicit ``None`` overrides an Optional field."""

    __slots__ = ()

    def __repr__(self):
        return "UNSET"


UNSET = _Unset()


def resolve_config(config: PartitionConfig | None = None,
                   where: str = "PartitionConfig",
                   **overrides) -> PartitionConfig:
    """Merge loose keyword overrides over a base ``config``; ``UNSET``
    values keep the base field, unknown names raise ``ValueError``."""
    unknown = sorted(set(overrides) - set(_FIELDS))
    if unknown:
        raise ValueError(
            f"{where}: unknown config settings {unknown}: known settings "
            f"are {list(_FIELDS)}")
    if config is not None and not isinstance(config, PartitionConfig):
        raise ValueError(
            f"{where}: config= must be a PartitionConfig, "
            f"got {type(config).__name__}")
    base = config if config is not None else PartitionConfig()
    changes = {kk: v for kk, v in overrides.items() if v is not UNSET}
    return dataclasses.replace(base, **changes) if changes else base
