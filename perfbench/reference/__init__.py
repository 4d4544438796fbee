"""The plain PyTorch reference the benchmark checks the program against.  It imports nothing of the program."""
