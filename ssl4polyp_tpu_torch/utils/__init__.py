"""Host-side utilities of the port: the checkpoint file format and its codec."""
