"""Game engines (Breakout in this slice of the port)."""
