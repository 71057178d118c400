"""neoprof_update kernel: wrapper (ops.py) and plain PyTorch version (ref.py)."""
