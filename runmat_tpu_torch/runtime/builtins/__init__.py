"""Copy of runmat_tpu/runtime/builtins/__init__.py in the PyTorch port."""
