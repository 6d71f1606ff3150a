"""Tools of the port (timing and measurement entry points)."""
