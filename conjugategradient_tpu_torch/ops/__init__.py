"""Device ops: BLAS-1, compensated dots, stencil SpMV and the CUDA stencil kernels."""
