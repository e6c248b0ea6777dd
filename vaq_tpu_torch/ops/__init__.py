"""Search and distance operators of the port (see the package docstring)."""
