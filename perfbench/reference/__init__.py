"""Plain PyTorch and NumPy references: they import nothing of the program."""
