"""Host utilities (synthetic histories)."""
