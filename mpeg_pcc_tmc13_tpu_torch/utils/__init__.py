"""Morton codes (numpy on the host, torch on the device)."""
