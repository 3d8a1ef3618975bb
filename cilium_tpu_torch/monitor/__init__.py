"""Monitor plane: the device event ring and its host decode."""
