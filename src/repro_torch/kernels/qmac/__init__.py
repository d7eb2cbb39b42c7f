"""Q-MAC: int8 matmul kernel for Hopper (csrc/qmac.cu)."""
