"""paged_attn kernel: wrapper (ops.py) and plain PyTorch version (ref.py)."""
