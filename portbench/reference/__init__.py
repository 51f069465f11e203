"""Plain PyTorch references the benchmark holds the program against.
They import nothing of the program under test."""
