"""The plain float32 reference and the comparison that decides ``correct``.
Plain ``torch``; nothing here imports the port or JAX."""
