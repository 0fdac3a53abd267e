"""The store's block framing (`format.py`), as the plan memo uses it."""
