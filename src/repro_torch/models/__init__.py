"""Model substrate: config, layers, attention, packed weights, the dense
decoder."""
