"""GPU twins of the repo-root dev tools: dataset generators, parity
fuzzing and sweeps against the exact oracle, a parity battery, a soak,
and stage profiles of ``TorchEngine``."""
