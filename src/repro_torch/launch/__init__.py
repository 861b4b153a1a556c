"""Launcher glue of the LM path: serving shapes and sessions."""
