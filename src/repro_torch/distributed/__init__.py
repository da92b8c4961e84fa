"""Distribution helpers of the port (single process so far)."""
