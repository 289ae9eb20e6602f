"""Scene data for the port (a seeded synthetic scene so far)."""
