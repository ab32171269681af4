"""Lazy DAG nodes whose concrete values are torch tensors.

The DAG itself (`LazyNode`, `topo_order`, `structure_key`) is the JAX
package's, reused as is; only the host transfer differs.
"""

from __future__ import annotations

import numpy as np

from runmat_tpu.accel.lazy import LazyNode, structure_key, topo_order  # noqa: F401


class TorchLazyNode(LazyNode):
    __slots__ = ()

    def gather(self) -> np.ndarray:
        """Materialize and copy to the host, in the logical MATLAB shape
        (device values are stored in their physical shape: vectors rank-1,
        scalars rank-0). Read-only, like a jax host copy: on the CPU the
        array shares the tensor's memory."""
        h = self.engine.materialize(self).cpu().numpy()
        h.setflags(write=False)
        if self.dispatch_id is not None:
            eng = self.engine
            eng.gathered_seq = max(eng.gathered_seq, self.dispatch_id)
        return h if h.shape == self.shape else h.reshape(self.shape)
