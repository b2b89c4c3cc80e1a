"""What makes a run reproducible: the code, the configuration, the stack."""
