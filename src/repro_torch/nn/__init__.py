"""Layers of the port: Q-MAC linear and embeddings, Q-Conv, the LSTM
cell, and the LM blocks (attention with its KV cache, RoPE, norms,
FFNs)."""
