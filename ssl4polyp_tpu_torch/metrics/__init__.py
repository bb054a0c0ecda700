"""Host-side classification metrics (numpy only)."""
