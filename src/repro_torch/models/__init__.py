"""Models driven through the PIM engine."""
