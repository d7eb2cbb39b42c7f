"""Layers of the port: Q-MAC linear and Q-Conv."""
