"""Copy of runmat_tpu/utils/__init__.py in the PyTorch port."""
