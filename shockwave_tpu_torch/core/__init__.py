"""Device-free helpers the port keeps its own copy of."""
