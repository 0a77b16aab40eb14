"""Model configurations the port carries (its own copies of the reference's)."""
