"""Device ops of the PyTorch port: the Threefry RNG (CUDA kernel and plain
PyTorch version), its build, and the elementwise op table."""
