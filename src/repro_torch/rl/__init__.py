"""RL side of the port: envs, nets and the inference path."""
