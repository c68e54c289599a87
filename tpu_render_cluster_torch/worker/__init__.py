"""The port's worker pieces: render backends (the worker runtime arrives with its own slice)."""
