"""Device ops: BLAS-1 (``ops.blas``), SpMV (``ops.spmv``), SpMM
(``ops.spmm``), extended precision (``ops.precision``), the stencil products
(``ops.stencil``) and the CUDA kernels with their plain twins
(``ops.cuda_stencil``, ``ops.cuda_dia``).

The names below are the JAX package's ``ops`` names, in its order, but for
its ``dd`` and ``pallas_spmv`` (ROADMAP: not to port).  ``ops.spmv`` is the
*submodule* (the dispatching function is ``ops.spmv.spmv``, exported here as
``matvec``); ``ops.spmm`` ends up as the *function*, as in the JAX package,
because its import comes after the submodule's.  Importing builds no kernel.
"""

from conjugategradient_tpu_torch.ops import blas, precision, spmm, spmv, stencil  # noqa: F401
from conjugategradient_tpu_torch.ops.blas import (  # noqa: F401
    axpy,
    dot,
    max_abs,
    norm_l2,
    residual_norm,
    scal,
)
from conjugategradient_tpu_torch.ops.spmv import as_operator  # noqa: F401
from conjugategradient_tpu_torch.ops.spmv import spmv as matvec  # noqa: F401
from conjugategradient_tpu_torch.ops.spmm import spmm  # noqa: F401
