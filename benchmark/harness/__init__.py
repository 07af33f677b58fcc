"""The benchmark harness of the PyTorch port: see ``main.py``."""
