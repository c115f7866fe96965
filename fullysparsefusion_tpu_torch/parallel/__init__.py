"""Training step: losses, backward, clip, AdamW with lr multipliers."""
