"""What the benchmark measures with: inputs from the seed, peaks and
counts of operations and bytes, and the reduction of a device trace."""
