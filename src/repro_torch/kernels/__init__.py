"""Hand-written CUDA kernels of the serving path, their plain PyTorch
versions and the device-dispatched API (``ops``).  Nothing is built or
loaded at import."""
