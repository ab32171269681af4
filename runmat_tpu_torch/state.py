"""Carry a session's state across engines.

`carry_session(src, dst)` gives `dst` the workspace and the RNG position of
`src`, so a script continued in `dst` computes what it would have computed in
`src`. Arrays cross as host numpy copies (`MatArray.host()`), whatever engine
held them; the RNG crosses as `(seed, key, counter)`.
"""

from __future__ import annotations

import copy

from runmat_tpu.values import MatArray


def carry_session(src, dst) -> None:
    for name, v in src.base_frame.vars.items():
        if isinstance(v, MatArray):
            v = MatArray(v.host().copy(), v.mclass)
        else:
            v = copy.deepcopy(v)
        dst.base_frame.vars[name] = v
    dst.rng.seed, dst.rng.key, dst.rng.counter = src.rng.state_tuple()
