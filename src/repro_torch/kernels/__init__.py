"""Hand-written CUDA kernels for Hopper (``../csrc``), their plain torch
versions (``ref``), and the wrappers the store calls (``ops``)."""
