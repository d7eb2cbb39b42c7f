"""Models of the port (``repro.models`` counterparts): the E2HRL agent,
the dense decoder LM and the whisper-style encoder-decoder."""
