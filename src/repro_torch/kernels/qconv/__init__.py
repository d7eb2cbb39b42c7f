"""Q-Conv: int8 implicit-GEMM conv kernel for Hopper (csrc/qconv.cu)."""
