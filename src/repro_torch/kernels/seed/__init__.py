from repro_torch.kernels.seed.kernel import greedy_seed  # noqa: F401
from repro_torch.kernels.seed.ref import greedy_seed_plain  # noqa: F401
