"""Platform services of the port (monitoring)."""
