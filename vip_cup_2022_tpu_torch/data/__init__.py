"""Host data layer of the port: JPEG decode pool and host-side resize."""
