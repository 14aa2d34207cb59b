"""HCMP at runtime: the draft/verify executor split (``executors.py``)."""
