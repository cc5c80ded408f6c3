"""Device kernels of the port (CUDA C++ sources in ../csrc) with their plain
torch versions."""
