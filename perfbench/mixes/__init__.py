"""Traffic programs, one module per mix, found by name."""
