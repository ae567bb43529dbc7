"""Traffic drivers, one module per loop kind; the mixes are the JSON files
beside them, found by the cell's `traffic` name."""
