"""The general part of the benchmark: it finds a cell's configuration,
traffic, limits and metric readers by name, and runs one cell once."""
