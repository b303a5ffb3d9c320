"""The benchmark's own arithmetic: operations and bytes of the model and of
single kernels, from configuration numbers and shapes alone."""
