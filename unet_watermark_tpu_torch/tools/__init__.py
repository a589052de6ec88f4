"""Tools run on the card by hand (kernel variant sweeps)."""
