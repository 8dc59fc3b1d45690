"""Data sources of the port (a copy of the reference's numpy-only token
stream)."""
