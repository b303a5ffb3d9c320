"""Traffic drivers, one module a kind of entry point, named by a traffic
file's ``driver``: each sets up the program from a configuration, runs
units of traffic in a window, and recomputes a sample with the
reference."""
