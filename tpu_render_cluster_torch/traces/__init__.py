"""Worker-side trace records."""
