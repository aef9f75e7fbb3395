"""The training objective's loss terms."""
