"""Q-LSTM: fused quantized LSTM cell kernel for Hopper (csrc/qlstm.cu)."""
