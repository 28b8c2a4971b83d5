"""Colour helpers (torch)."""
