"""Model configurations the port can serve."""
