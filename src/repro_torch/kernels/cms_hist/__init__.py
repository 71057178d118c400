"""cms_hist kernel: wrapper (ops.py) and plain PyTorch version (ref.py)."""
