"""Host utilities of the port: seeding and metric logging."""
