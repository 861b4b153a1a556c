"""AdamW, plain and ZeRO-1."""
