"""Plain float32 PyTorch references.  Nothing here imports the program
under test."""
