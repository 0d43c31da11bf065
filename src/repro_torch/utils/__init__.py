"""Hardware constants."""
