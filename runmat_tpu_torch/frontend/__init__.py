"""Copy of runmat_tpu/frontend/__init__.py in the PyTorch port."""
