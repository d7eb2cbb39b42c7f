"""Quantization core of the port (see repro_torch.core.fxp, qmatmul)."""
