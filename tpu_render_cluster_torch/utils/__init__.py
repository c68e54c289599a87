"""Small host-side utilities."""
