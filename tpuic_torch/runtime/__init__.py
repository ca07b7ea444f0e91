"""Process-level runtime helpers of the port (stdlib only)."""
