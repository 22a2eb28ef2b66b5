"""Serving steps over the decoder (prefill, decode)."""
