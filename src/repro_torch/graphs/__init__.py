from repro_torch.graphs.generators import grid2d, rmat  # noqa: F401
