"""Models of the port (``repro.models`` counterparts): the E2HRL agent,
the dense decoder LM, the whisper-style encoder-decoder, the Mamba2 ssm
LM and the RecurrentGemma-style hybrid."""
