"""Tools that set the benchmark up on the card: the readings that the
limits of its check come from."""
