"""NeoMem core: the NeoProf sketch, Algorithm 1 and 2Q placement (PyTorch)."""
