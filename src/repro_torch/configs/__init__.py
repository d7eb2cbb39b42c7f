"""Model configurations of the port (``repro.configs`` counterparts)."""
from repro_torch.configs.e2hrl import CONFIG, CONFIG_LSTM, HRLConfig

__all__ = ["CONFIG", "CONFIG_LSTM", "HRLConfig"]
