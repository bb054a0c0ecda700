"""On-device input preparation."""
