"""Plain references that decide ``correct``: PyTorch and NumPy only,
nothing of the program."""
