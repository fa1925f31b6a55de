"""The port's benchmark harnesses: legs that serve the system end to end
and return rows for a check to read."""
