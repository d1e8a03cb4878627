"""Hand-written CUDA kernels of the PyTorch port, one package per kernel."""
