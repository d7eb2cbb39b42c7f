"""Models of the port (``repro.models`` counterparts): the E2HRL agent
and the dense decoder LM."""
