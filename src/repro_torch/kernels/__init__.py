"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``), their
``ctypes`` wrappers (``ell_spmv``), the plain PyTorch versions (``ref``) and
the container-level dispatch (``ops``)."""
