"""The optimizer: AdamW written out, as in the reference."""
