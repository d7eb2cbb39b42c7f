"""V-ACT: CORDIC activation kernels for Hopper (csrc/vact.cu)."""
