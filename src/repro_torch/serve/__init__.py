"""Serving: the single-request paged engine with the NeoMem loop."""
