from repro_torch.kernels.gain.kernel import gain_scoreboard  # noqa: F401
from repro_torch.kernels.gain.ref import gain_scoreboard_plain  # noqa: F401
