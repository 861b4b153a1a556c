"""Entry points of the LM path: the serving builders."""
