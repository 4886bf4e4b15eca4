"""Hand-written CUDA kernels of the port (see ``_build``)."""
