"""What every cell of the benchmark shares: the cell's files, the run's
environment, the generators, the weights, the trace reader and the
comparison that decides ``correct``."""
