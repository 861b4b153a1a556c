"""Launcher glue of the LM path: serving shapes, stacked meshes and
sessions (serving and training)."""
