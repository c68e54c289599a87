"""Job definitions: the TOML job model (own copy of the reference model)."""
