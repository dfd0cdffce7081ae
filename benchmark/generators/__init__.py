"""Traffic generators, one module a kind of input, each found by the name a
traffic file gives under "generator".  A generator takes the traffic file's
parameters and a seed and makes the same inputs for the same seed."""
