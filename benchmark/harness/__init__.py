"""The harness: what every run of the benchmark shares."""
