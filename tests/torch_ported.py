"""A JAX test module read against the port alone.

`ported(module)` executes the source of the JAX package's test module
`module` again, as a new module, with every import of `runmat_tpu` read as
`runmat_tpu_torch`, and a command line the test starts in a subprocess
(`-m runmat_tpu.cli`) read as the port's on the host (`-m
runmat_tpu_torch.cli --no-accel`; without a card the port's command line
refuses to start a session otherwise). The test's own assertions then hold
the port. Paths such as `~/.runmat_tpu` are left as they are: both packages
keep their user files there.
"""

from __future__ import annotations

import inspect
import re
import types

_NAME = re.compile(r"(?<![./\w])runmat_tpu(?!\w)")
_CLI = '"runmat_tpu.cli"'


def ported(module) -> types.ModuleType:
    src = inspect.getsource(module)
    src = src.replace(_CLI, '"runmat_tpu_torch.cli", "--no-accel"')
    src = _NAME.sub("runmat_tpu_torch", src)
    mod = types.ModuleType(f"ported_{module.__name__}")
    mod.__file__ = module.__file__
    exec(compile(src, module.__file__, "exec"), mod.__dict__)
    return mod
