"""Copy of runmat_tpu/fea/__init__.py in the PyTorch port.

FEA stack: geometry, structured tet meshing, assembly, solves, pipelines.

Reference parity: the runmat-geometry / runmat-meshing / runmat-analysis-fea
layer (SURVEY.md L10): six pipelines run_linear_static / run_modal /
run_thermal / run_transient / run_nonlinear / run_electromagnetic
(crates/runmat-analysis/fea/src/lib.rs:16-21), tet meshing
(runmat-meshing/tetrahedron), assembly + solves (fea/src/{assembly,solve}).

TPU-native design: element stiffness matrices are computed for ALL elements
at once with batched einsum (vectorizes onto the MXU when the engine is
active), assembled into the CSC SparseMatrix, and solved with the
Jacobi-preconditioned CG whose matvec is a jax BCOO spmv on device
(runmat_tpu/sparse.py) — large models never densify.
"""

from .mesh import box_mesh
from .pipelines import (run_electromagnetic, run_linear_static, run_modal,
                        run_nonlinear, run_thermal, run_transient)

__all__ = ["box_mesh", "run_linear_static", "run_modal", "run_thermal",
           "run_transient", "run_nonlinear", "run_electromagnetic"]
