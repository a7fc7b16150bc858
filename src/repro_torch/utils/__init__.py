"""Parameter trees, FLOPs accounting and device selection."""
