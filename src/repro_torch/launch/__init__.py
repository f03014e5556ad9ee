"""Process-level runtime helpers (device selection, precision, provenance)."""
