"""The engine of the PyTorch port: `TorchEngine`, its DAG nodes and the
`for`-loop fold."""
