"""Entry points of the port (static LM serving)."""
