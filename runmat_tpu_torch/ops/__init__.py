"""Device ops of the PyTorch port: the Threefry RNG (CUDA kernel and plain
PyTorch version), its build, and the elementwise op table."""


# the modules of the kernels the port launches, each with its `launches`
# and `launches_by` counters
KERNEL_MODULES = ("threefry", "histogram", "fused", "iir", "spcg", "lstm",
                  "lstm_seq", "optim", "cmap", "eig_qr")


def kernel_modules() -> dict:
    """The modules of KERNEL_MODULES, by name."""
    import importlib
    return {m: importlib.import_module(f"{__name__}.{m}")
            for m in KERNEL_MODULES}


def zero_launches() -> None:
    """Sets every kernel module's `launches` and `launches_by` to 0."""
    for mod in kernel_modules().values():
        mod.launches = 0
        mod.launches_by.clear()


def launch_counts() -> dict:
    """Each kernel module's `launches_by`, by module name: what its kernels
    launched since the process started (or since `zero_launches`). A key
    of several parts (the generated kernels' (label, module)) is joined by
    spaces, so the result is JSON as it is."""
    return {m: {" ".join(k) if isinstance(k, tuple) else k: v
                for k, v in mod.launches_by.items()}
            for m, mod in kernel_modules().items()}
