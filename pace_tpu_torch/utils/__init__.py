"""Pure-Python helpers of the port (the configuration loader)."""
