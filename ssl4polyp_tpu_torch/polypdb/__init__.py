"""Data-pack tooling of the port: the synthetic pack generator."""
