"""Copy of runmat_tpu/vm/__init__.py in the PyTorch port."""
