"""Host-side data steps of the port (numpy, no torch)."""
