"""Offline dataset tooling: corruption variant builders and the polypdb CLI."""
