"""Profile encoders."""
