"""CSV-in / CSV-out inference engine of the port."""
