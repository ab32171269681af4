"""The error a script gets where it reaches what the port does not carry yet.

The port copies the host layers of `runmat_tpu` module by module (ROADMAP
Queue A). A copied module that reaches a module, value type or engine
method the port lacks calls `not_ported`, which raises a `MatError` naming
the ROADMAP item, so the script sees a MATLAB error and not a Python one.
"""

from __future__ import annotations

from .errors import MatError

IDENTIFIER = "RunMat:notPorted"


def not_ported(what: str, item: str):
    raise MatError(IDENTIFIER, f"{what} is not yet ported (ROADMAP {item})")
