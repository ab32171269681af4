"""Copy of runmat_tpu/dl/__init__.py in the PyTorch port: the deep-learning
helpers (autodiff over the lazy DAG, the ONNX codec)."""
