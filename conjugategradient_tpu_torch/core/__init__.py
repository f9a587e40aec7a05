"""Host-side containers, generators, ingestion and the fp64 oracle.

The containers (``formats``): ``DiaMatrix``, ``StencilMatrix`` and
``ConstStencilMatrix`` (the kernels' formats), and ``EllMatrix``,
``CsrMatrix``, ``CooMatrix``, ``BsrMatrix`` and ``DenseMatrix`` with their
conversions; ``DokBuilder`` (``builder``), Matrix Market and scipy
ingestion (``io``) and the row-block partition math (``partition``).
"""

from conjugategradient_tpu_torch.core.builder import DokBuilder  # noqa: F401
from conjugategradient_tpu_torch.core.formats import (  # noqa: F401
    BsrMatrix,
    ConstStencilMatrix,
    CooMatrix,
    CsrMatrix,
    DenseMatrix,
    DiaMatrix,
    EllMatrix,
    StencilMatrix,
    coo_to_csr,
    csr_to_dense,
    csr_to_dia,
    csr_to_ell,
    dense_to_csr,
    dia_to_csr,
    dia_to_dense,
    ell_to_csr,
    is_symmetric,
    transpose,
)
from conjugategradient_tpu_torch.core.io import (  # noqa: F401
    from_scipy,
    load_matrix_market,
    load_vector_market,
    save_matrix_market,
    save_vector_market,
    to_scipy,
)
from conjugategradient_tpu_torch.core.partition import RowBlockPartition, partition_dia  # noqa: F401
