"""Weight bridges into the port's modules."""
