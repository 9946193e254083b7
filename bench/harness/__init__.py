"""What every cell of the benchmark shares: inputs, the run, the program's
counters and spans, the device trace, the byte counts."""
