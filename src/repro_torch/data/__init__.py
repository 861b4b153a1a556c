"""The synthetic LM data pipeline."""
