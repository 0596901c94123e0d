"""Training: optimizer, train steps, the staged MCTF curriculum."""
