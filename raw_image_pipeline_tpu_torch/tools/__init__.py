"""Command-line tools of the PyTorch port (run with python -m)."""
