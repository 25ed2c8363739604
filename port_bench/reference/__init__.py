"""The plain PyTorch reference the benchmark holds the program against.
Nothing here imports the program under test."""
