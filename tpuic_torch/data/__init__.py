"""Input data for the port (the serving slice needs the transforms only)."""
