"""Copy of runmat_tpu/runtime/__init__.py in the PyTorch port."""
