"""Training substrate."""
