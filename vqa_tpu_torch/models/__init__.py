"""Model modules of the port (attention model)."""
